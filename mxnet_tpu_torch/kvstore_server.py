"""The server role, counterpart of ``mxnet_tpu/kvstore_server.py``
(the reference's ``python/mxnet/kvstore_server.py``: a process launched
with ``DMLC_ROLE=server`` ran ``KVStoreServer.run()`` until the job
stopped, applying the optimizer the workers sent).

``dist_sync`` has no server process (the exchange is a collective), and
``dist_async``'s server is a thread of rank 0 unless a server process
owns its address (:mod:`mxnet_tpu_torch.parallel.ps`). This module keeps
the reference's launch contract: importing it in a process whose
``DMLC_ROLE`` is ``server`` hosts the parameter server at
``ps_address()`` and blocks until a worker stops it. The package's
``__init__`` does not import it.
"""
from __future__ import annotations

import os
import time

from .parallel import ps


class KVStoreServer:
    """The server loop. The optimizer arrives over the wire
    (``set_optimizer``), as every other command does."""

    def __init__(self, num_workers: int | None = None):
        self.num_workers = num_workers or int(
            os.environ.get("MXTPU_NUM_WORKERS",
                           os.environ.get("DMLC_NUM_WORKER", "1")))
        host, port = ps.ps_address()
        self._server = ps.ParameterServer(host, port, self.num_workers)

    def run(self):
        """Block until the server is stopped (a worker's ``stop``)."""
        try:
            while not self._server._stop.is_set():
                time.sleep(0.2)
        finally:
            self._server.close()


def _init_kvstore_server_module():
    """Run the server when this process has the server role
    (``DMLC_ROLE=server``); otherwise do nothing."""
    if os.environ.get("DMLC_ROLE", "") == "server":
        KVStoreServer().run()


_init_kvstore_server_module()
