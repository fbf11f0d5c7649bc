"""A plain torch model of the arithmetic of the port's tensor-core kernels
(csrc/tf32x3.cuh, csrc/gemm_tile.cuh, csrc/flash_attn.cu), for
tests/test_torch_tf32x3.py on the CPU and tests/test_torch_cuda.py on the
card. It imports neither jax nor the JAX package.

The model: TF32 rounding as ``cvt.rna.tf32.f32`` does it (round to 10
mantissa bits, to nearest, ties away from zero, on the int32 bits); every
operand split as hi = tf32(x), lo = x - hi, which the MMA truncates to
TF32; each m16n8k8 product adds the exact sum of its 8 products to a
float32 fragment, rounded toward zero (a model of the tensor cores'
truncating adds), the three products of a fragment in the kernels' order,
hi*lo, lo*hi, hi*hi. In K3 a BK-deep step's products, in K2's P V a key
tile's, chain into a fragment from zero that is then added to the running
sum with rounding to nearest; K2's scores chain from zero over D. K3 splits
K as ``gemm_tile.cuh``'s k_chunk does and sums the splits in order in
float32. K1 splits K as ``linear.cu``'s linear_k_chunk does and sums its splits
the same way. K2 walks key tiles with the online softmax in base 2."""
import math

import torch

from mxnet_tpu_torch.ops import kernels as tk

# gemm_tile.cuh: BM, BK, kMaxSplits; an H100 SXM's SMs
BM, BK, MAX_SPLITS, SMS = 128, 32, 256, 132
# conv_gemm.cu's and linear.cu's kMinSplitK
CONV_MIN_SPLIT, LINEAR_MIN_SPLIT = 256, 64
# linear.cu's narrow tile (kNarrowM x kNarrowN) and its most splits
# (kMaxClusterSplits: the splits of a tile are one cluster)
LINEAR_NARROW_M, LINEAR_NARROW_N, LINEAR_MAX_SPLITS = 32, 64, 8
LOG2E = 1.4426950408889634


def tf32(x):
    """cvt.rna.tf32.f32 on float32 ``x``: the low 13 mantissa bits cleared
    after adding half of them, which rounds the magnitude to nearest with
    ties away from zero (the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    """hi = tf32(x) and lo = x - hi as the MMA reads it: its top 19 bits
    (the low 13 truncated)."""
    hi = tf32(x)
    lo = (x - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def terms(a, b, passes):
    """The (A, B) operand pairs of one fragment's products, in order: one
    TF32 pass, or the three of 3xTF32."""
    if passes == 1:
        return [(tf32(a), tf32(b))]
    (ah, al), (bh, bl) = split(a), split(b)
    return [(ah, bl), (al, bh), (ah, bh)]


def rz(x):
    """float64 ``x`` to float32 rounded toward zero: how the tensor cores
    round the sum into their float32 accumulator."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma_sum(acc, a, b, passes=3, run=None):
    """acc (..., M, N) float32 += a (..., M, K) @ b (..., K, N) the way the
    kernels' m16n8k8 products add up: k-steps of 8 in order; each product's
    8 terms summed exactly and added, with truncation, to the fragment it
    chains into. The products of ``run`` k-steps chain into a fragment from
    zero that is then added to acc rounding to nearest (tf32x3.cuh's add);
    with ``run`` None they chain into acc itself."""
    k = a.shape[-1]
    pad = -k % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ops = terms(a, b, passes)
    steps = (k + pad) // 8
    frag = acc if run is None else torch.zeros_like(acc)
    for i in range(steps):
        for x, y in ops:
            prod = x[..., 8 * i:8 * i + 8].double() \
                @ y[..., 8 * i:8 * i + 8, :].double()
            frag = rz(frag.double() + prod)
        if run is not None and ((i + 1) % run == 0 or i + 1 == steps):
            acc = (acc.double() + frag.double()).float()
            frag = torch.zeros_like(acc)
    return frag if run is None else acc


def k_chunk(m, n, k, min_split=CONV_MIN_SPLIT, sms=SMS):
    """gemm_tile.cuh's split-K rule (``k_chunk``) on a card of ``sms`` SMs,
    one block an SM. tests/test_torch_cuda.py holds it to the built
    libraries' ``conv_gemm_k_chunk`` and ``linear_k_chunk``."""
    if m <= 0 or n <= 0 or k <= 0:
        return BK
    tn = 64 if n <= 64 else 128
    tiles = -(-m // BM) * -(-n // tn)
    splits = 1
    if tiles < sms:
        most = min(k // min_split, MAX_SPLITS)
        least = -(-sms // tiles)
        if least >= most:
            splits = max(most, 1)
        else:
            # the share of the last wave used, blocks / (waves * sms),
            # compared as a cross product
            best_used, best_waves = -1, 1
            for s in range(least, min(most, 4 * least) + 1):
                blocks = tiles * s
                waves = -(-blocks // sms)
                if best_used < 0 or blocks * best_waves > best_used * waves:
                    best_used, best_waves, splits = blocks, waves, s
    per = -(-k // splits)
    return -(-per // BK) * BK


def linear_k_chunk(m, n, k, sms=SMS):
    """linear.cu's split-K rule (``linear_k_chunk``) on a card of ``sms``
    SMs: one split for a layer with two thirds of a wave of wide tiles
    (one block an SM), else narrow tiles and as many splits as fill about
    one wave of one block an SM, between one and k / LINEAR_MIN_SPLIT, at
    most LINEAR_MAX_SPLITS. tests/test_torch_cuda.py holds it to the
    built library."""
    if m <= 0 or n <= 0 or k <= 0:
        return BK
    tn = 64 if n <= 64 else 128
    splits = 1
    if 3 * (-(-m // BM) * -(-n // tn)) < 2 * sms:
        most = min(k // LINEAR_MIN_SPLIT, LINEAR_MAX_SPLITS)
        tiles = -(-m // LINEAR_NARROW_M) * -(-n // LINEAR_NARROW_N)
        splits = max(min(sms // tiles, most), 1)
    per = -(-k // splits)
    return -(-per // BK) * BK


def gemm_model(a, b, passes=3, chunk=None):
    """K3's float32 result for a (M, K) @ b (K, N): each split's K range
    (``chunk``, by default K3's :func:`k_chunk`) through :func:`mma_sum`,
    then the splits summed in order."""
    m, k = a.shape
    n = b.shape[1]
    chunk = k_chunk(m, n, k) if chunk is None else chunk
    splits = -(-k // chunk)
    pad = splits * chunk - k
    a = torch.nn.functional.pad(a, (0, pad)).reshape(m, splits, chunk)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(splits, chunk, n)
    ws = mma_sum(torch.zeros(splits, m, n), a.permute(1, 0, 2), b, passes,
                 BK // 8)
    out = ws[0]
    for z in range(1, splits):
        out = out + ws[z]
    return out


def linear_model(x, w, b, act="none"):
    """K1's float32 result: :func:`gemm_model` of x @ w.T split by
    :func:`linear_k_chunk`, then the bias and the activation once."""
    m, k = x.shape
    y = gemm_model(x, w.t().contiguous(),
                   chunk=linear_k_chunk(m, w.shape[0], k)) + b
    return {"none": y, "relu": torch.relu(y), "tanh": torch.tanh(y),
            "sigmoid": torch.sigmoid(y)}[act]


def attention_model(q, k, v, causal, bkv, passes=3):
    """K2's arithmetic over (B, T, H, D): scores by TF32 products over D
    chained into their fragments, scaled into base 2, masked with -1e30,
    an online softmax over key tiles of ``bkv`` rows, P V by TF32 products
    over the tile's keys, o / l. ``passes`` 3 is the kernel's 3xTF32; 1 is
    a single TF32 pass."""
    b, t, h, d = q.shape
    qh, kh, vh = (x.permute(0, 2, 1, 3).reshape(b * h, t, d)
                  for x in (q, k, v))
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    rows = torch.arange(t)[:, None]
    m = torch.full((b * h, t, 1), -1e30)
    l = torch.zeros(b * h, t, 1)
    o = torch.zeros(b * h, t, d)
    for k0 in range(0, t, bkv):
        kt, vt = kh[:, k0:k0 + bkv], vh[:, k0:k0 + bkv]
        s = mma_sum(torch.zeros(b * h, t, kt.shape[1]), qh,
                    kt.transpose(1, 2), passes) * scale_log2
        keys = k0 + torch.arange(kt.shape[1])[None, :]
        if causal:
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        o = mma_sum(o * alpha, p, vt, passes, run=bkv // 8)
    return (o / l).reshape(b, h, t, d).permute(0, 2, 1, 3)


def within_k3_contract(got, a, b):
    """Every element within 1e-6 * sum|a||b| of the float64 product."""
    ad, bd = a.double(), b.double()
    err = (got.double() - ad @ bd).abs()
    return bool((err <= 1e-6 * (ad.abs() @ bd.abs())).all())


def within_k2_contract(got, q, k, v, causal):
    """Within rtol 2e-4 / atol 2e-5 of flash_attention_plain."""
    want = tk.flash_attention_plain(q, k, v, causal=causal)
    return bool(torch.isclose(got, want, rtol=2e-4, atol=2e-5).all())
