"""Find the order in which XLA's CPU program sums a bf16 convolution.

The JAX det (``vse_tpu/models/ppocr_det.py``) runs its convolutions on bf16
operands with f32 sums. A product of two bf16 values is exact in f32, so
only the order of the f32 additions decides the result. This script:

1. reconstructs the summation tree of a depthwise convolution
   (``feature_group_count = C``) from cancellation probes: the kernel of
   channel c holds 2^24 at tap i, -2^24 at tap j and 1 at tap l on an
   all-ones image, so the output is 1 exactly when i and j cancel before
   the 1 meets the positive one; both signs give, for each pair of taps,
   the size of the subtree where they meet;
2. holds the found trees (``depthwise_sum``), the sequential, row-blocked
   order of the plain 3x3 convolutions (``regular_sum``) and, for the 1x1
   convolutions, both a sequential sum and four accumulators over k mod 4
   joined pairwise (``dot4_sum``) against ``jax.jit`` of
   ``lax.conv_general_dilated`` on random bf16 data at the det's kernel
   sizes, strides and widths, and prints the outputs that differ (0 where
   the order is right).

Run with JAX on the CPU:

    JAX_PLATFORMS=cpu python tools/probe_xla_conv_order.py
"""

from __future__ import annotations

import itertools

import numpy as np

F32 = np.float32


def _conv(x, w, stride, pad, groups):
    import jax
    import jax.numpy as jnp
    from jax import lax

    def f(x, w):
        return lax.conv_general_dilated(
            x, w, (stride, stride), [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
            preferred_element_type=jnp.float32)
    return np.asarray(jax.jit(f)(jnp.asarray(x).astype(jnp.bfloat16),
                                 jnp.asarray(w).astype(jnp.bfloat16)))


def probe_tree(k: int, C: int = 64, H: int = 9, W: int = 13, stride: int = 1) -> str:
    """The summation tree of a k x k depthwise convolution over its taps
    (row-major kernel positions), as nested sums."""
    K = k * k
    triples = [(i, j, l) for i, j in itertools.permutations(range(K), 2)
               for l in range(K) if l not in (i, j)]
    val = {}
    for s in range(0, len(triples), C):
        chunk = triples[s : s + C]
        w = np.zeros((K, C), np.float32)
        for c, (i, j, l) in enumerate(chunk):
            w[i, c], w[j, c], w[l, c] = 2.0 ** 24, -(2.0 ** 24), 1.0
        y = _conv(np.ones((1, H, W, C), np.float32), w.reshape(k, k, 1, C), stride, 0, C)
        for c, t in enumerate(chunk):
            v = np.unique(y[0, :, :, c])
            if len(v) != 1:
                raise SystemExit(f"tap triple {t}: the order depends on the position {v}")
            val[t] = float(v[0])
    meet = {}
    for i, j in itertools.combinations(range(K), 2):
        outside = sum(val[(i, j, l)] == 1.0 and val[(j, i, l)] == 1.0
                      for l in range(K) if l not in (i, j))
        meet[(i, j)] = K - outside

    def build(items):
        if len(items) == 1:
            return str(items[0])
        n, first = len(items), items[0]
        g1 = [first] + [x for x in items[1:] if meet[tuple(sorted((first, x)))] < n]
        g2 = [x for x in items if x not in g1]
        return f"({build(g1)}+{build(g2)})"
    return build(list(range(K)))


def _add(a, b):
    return (a + b).astype(F32)


def depthwise_sum(t):
    """XLA's CPU order for the 3x3 and 5x5 depthwise taps ``t`` (row-major)."""
    if len(t) == 9:
        return _add(_add(_add(_add(t[0], t[1]), _add(t[4], t[5])),
                         _add(_add(t[2], t[3]), _add(t[6], t[7]))), t[8])
    lanes = [_add(t[p], t[p + 8]) for p in range(8)]
    a = _add(_add(_add(lanes[0], lanes[1]), _add(lanes[4], lanes[5])),
             _add(_add(lanes[2], lanes[3]), _add(lanes[6], lanes[7])))
    b = _add(_add(_add(t[16], t[17]), _add(t[20], t[21])),
             _add(_add(t[18], t[19]), _add(t[22], t[23])))
    return _add(_add(a, b), t[24])


def regular_sum(t, block):
    """Sequential over (ky, kx, c) in blocks of ``block`` taps, the blocks'
    sums added in turn."""
    out = None
    for b in range(0, len(t), block):
        s = t[b]
        for v in t[b + 1 : b + block]:
            s = _add(s, v)
        out = s if out is None else _add(out, s)
    return out


def dot4_sum(t):
    """Four accumulators over k mod 4, joined as (a0 + a1) + (a2 + a3)."""
    acc = [None] * 4
    for k, v in enumerate(t):
        acc[k % 4] = v if acc[k % 4] is None else _add(acc[k % 4], v)
    acc = [np.zeros_like(t[0]) if a is None else a for a in acc]
    return _add(_add(acc[0], acc[1]), _add(acc[2], acc[3]))


def mismatches(cin, cout, k, stride, H, W, groups, order, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, H, W, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin // groups, cout)).astype(np.float32)
    ref = _conv(x, w, stride, k // 2, groups)
    # the same bf16 values in numpy, each product exact in f32
    import jax.numpy as jnp

    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)).astype(np.float64)
    wb = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32)).astype(np.float64)
    p = k // 2
    xp = np.pad(xb, ((0, 0), (p, p), (p, p), (0, 0)))
    oh, ow = ref.shape[1:3]
    win = lambda a, b: xp[:, a : a + stride * oh : stride, b : b + stride * ow : stride]  # noqa: E731
    if groups > 1:
        taps = [(win(a, b) * wb[a, b, 0]).astype(F32) for a in range(k) for b in range(k)]
    else:
        taps = [(win(a, b)[..., c, None] * wb[a, b, c]).astype(F32)
                for a in range(k) for b in range(k) for c in range(cin)]
    return int((order(taps) != ref).sum()), ref.size


def main() -> None:
    for k in (3, 5):
        for stride in (1, 2):
            print(f"depthwise {k}x{k} stride {stride}: {probe_tree(k, stride=stride)}")
    cases = [
        ("depthwise 3x3, C 64, 24 x 24", (64, 64, 3, 1, 24, 24, 64), depthwise_sum),
        ("depthwise 3x3 stride 2, C 120, 20 x 60", (120, 120, 3, 2, 20, 60, 120), depthwise_sum),
        ("depthwise 5x5, C 64, 24 x 24", (64, 64, 5, 1, 24, 24, 64), depthwise_sum),
        ("depthwise 5x5 stride 2, C 40, 30 x 50", (40, 40, 5, 2, 30, 50, 40), depthwise_sum),
        ("stem 3x3 stride 2, 3 -> 8, 192 x 960",
         (3, 8, 3, 2, 192, 960, 1), lambda t: regular_sum(t, 27)),
        ("neck/head 3x3, 96 -> 24, 48 x 240",
         (96, 24, 3, 1, 48, 240, 1), lambda t: regular_sum(t, 288)),
        ("neck/head 3x3, 96 -> 24, 48 x 240, one sequential sum",
         (96, 24, 3, 1, 48, 240, 1), lambda t: regular_sum(t, 864)),
    ]
    # the 1x1 convolutions: the order depends on the shape
    for cin, cout in ((16, 40), (120, 40), (40, 120), (336, 56), (480, 96), (80, 480)):
        for name, order in (("four accumulators", dot4_sum),
                            ("sequential", lambda t: regular_sum(t, len(t)))):
            cases.append((f"1x1 {cin} -> {cout}, 12 x 20, {name}",
                          (cin, cout, 1, 1, 12, 20, 1), order))
    for label, args, order in cases:
        bad, n = mismatches(*args, order=order)
        print(f"{label}: {bad} of {n} outputs differ from jax.jit", flush=True)


if __name__ == "__main__":
    main()
