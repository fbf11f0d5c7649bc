"""Network visualization, counterpart of ``mxnet_tpu/visualization.py``:
``print_summary``'s text table (the same text as the JAX package's for
the same symbol and shapes) and ``plot_network``'s graphviz digraph,
which raises without the graphviz package."""
from __future__ import annotations

import json
from typing import Dict, Optional

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape: Optional[Dict] = None, line_length: int = 120,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Layer-by-layer summary with params count (reference print_summary)."""
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        arg_shapes, out_shapes, _ = symbol.get_internals().infer_shape_partial(**shape)
        internals = symbol.get_internals()
        for name, s in zip(internals.list_outputs(), out_shapes):
            shape_dict[name] = s

    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = {h[0] for h in conf["heads"]}
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    lines = []

    def print_row(f, pos):
        line = ""
        for i, field in enumerate(f):
            line += str(field)
            line = line[:pos[i]]
            line += " " * (pos[i] - len(line))
        lines.append(line)

    lines.append("=" * line_length)
    print_row(fields, positions)
    lines.append("=" * line_length)
    total_params = 0
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null" and i not in heads:
            continue
        out_shape = shape_dict.get(name + "_output", "") if show_shape else ""
        pre = [nodes[j]["name"] for j, _ in node["inputs"]
               if nodes[j]["op"] != "null" or True]
        params = 0
        if show_shape:
            for j, _ in node["inputs"]:
                jn = nodes[j]
                if jn["op"] == "null" and (
                        jn["name"].endswith("weight") or jn["name"].endswith("bias")
                        or jn["name"].endswith("gamma") or jn["name"].endswith("beta")):
                    # variable outputs are listed under their bare name
                    s = shape_dict.get(jn["name"]) or \
                        shape_dict.get(jn["name"] + "_output")
                    if s:
                        n = 1
                        for d in s:
                            n *= d
                        params += n
        total_params += params
        print_row(["%s(%s)" % (name, op), str(out_shape), str(params),
                   ",".join(pre[:2])], positions)
    lines.append("=" * line_length)
    lines.append("Total params: %d" % total_params)
    lines.append("=" * line_length)
    out = "\n".join(lines)
    print(out)
    return out


def plot_network(symbol, title: str = "plot", shape: Optional[Dict] = None,
                 node_attrs: Optional[Dict] = None):
    """Graphviz digraph of the symbol (reference plot_network). Requires the
    ``graphviz`` package; raises a clear error otherwise."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires the graphviz package")
    node_attrs = node_attrs or {}
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title)
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null":
            if name.endswith("weight") or name.endswith("bias") or \
                    name.endswith("gamma") or name.endswith("beta"):
                continue
            dot.node(name=name, label=name, fillcolor="#8dd3c7", **node_attr)
        else:
            dot.node(name=name, label="%s\n%s" % (op, name),
                     fillcolor="#fb8072", **node_attr)
    for node in nodes:
        if node["op"] == "null":
            continue
        for j, _ in node["inputs"]:
            jn = nodes[j]
            if jn["op"] == "null" and (
                    jn["name"].endswith("weight") or jn["name"].endswith("bias")
                    or jn["name"].endswith("gamma") or jn["name"].endswith("beta")):
                continue
            dot.edge(jn["name"], node["name"])
    return dot
