"""The yardstick's arithmetic: the work of each served and trained call,
counted from the configuration's layer shapes, and the published peaks
that it is divided by.

Copied from the repository's ``chip_smoke.py`` (``stages``,
``serving_work``, ``relaynet_stages``, ``relaynet_work``, ``train_convs``,
``bound``, ``PEAK``, ``HBM``) with the width, classes and image side taken
as arguments, so that the benchmark's yardstick does not move when the
program or its smoke test does. A count never depends on which kernel
computes a layer. Each configuration's reference module turns these into
its ``forward_ops(cfg)``.
"""

from __future__ import annotations

# H100 SXM published dense peaks and HBM rate (NVIDIA data sheet), at the
# card's full 700 W power limit
PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}
HBM = 3.35e12


def bound(ops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes") for ``ops`` at ``peak``
    op/s and ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# U-Net (3x3 convs, 2x2/2 transposed convs, 1x1 head)
# ---------------------------------------------------------------------------


def stages(f: int, hw: int) -> list[tuple[str, str, tuple]]:
    """Every int8 call of one served U-Net forward: (name, kernel, shape).
    conv: (H, cins, cout, pool); ct: (H_in, cin, cout); head: (H, cin)."""
    out = [("stem blk0_conv0", "conv3x3_int8", (hw, (1,), f, False)),
           ("blk0_conv1", "conv3x3_int8", (hw, (f,), f, True))]
    h, c = hw // 2, f
    for i in range(1, 4):  # blk1..blk3
        out += [(f"blk{i}_conv0", "conv3x3_int8", (h, (c,), 2 * c, False)),
                (f"blk{i}_conv1", "conv3x3_int8", (h, (2 * c,), 2 * c, True))]
        h, c = h // 2, 2 * c
    out += [("blk4_conv0", "conv3x3_int8", (h, (c,), 2 * c, False)),
            ("blk4_conv1", "conv3x3_int8", (h, (2 * c,), 2 * c, False))]
    c *= 2
    for k, blk in enumerate((5, 6, 7, 8)):
        out.append((f"ct{k}", "ct2x2_int8", (h, c, c // 2)))
        h, c = 2 * h, c // 2
        out += [(f"blk{blk}_conv0", "conv3x3_int8", (h, (c, c), c, False)),
                (f"blk{blk}_conv1", "conv3x3_int8", (h, (c,), c, False))]
    out.append(("head", "head_argmax", (h, c)))
    return out


def serving_work(kernel: str, shape: tuple, n: int,
                 nc: int) -> tuple[float, float]:
    """(int8 ops, bytes) of one served U-Net call at batch n: each input
    read once, each output written once."""
    if kernel == "conv3x3_int8":
        h, cins, cout, pool = shape
        cin = sum(cins)
        out = n * h * h * cout * (1.25 if pool else 1)
        return (2 * n * h * h * 9 * cin * cout,
                n * h * h * cin + 9 * cin * cout + 8 * cout + out)
    if kernel == "ct2x2_int8":
        h, cin, cout = shape
        return (2 * n * h * h * cin * cout * 4,
                n * h * h * cin + 4 * cin * cout + 8 * cout
                + n * 4 * h * h * cout)
    h, cin = shape
    return (2 * n * h * h * cin * nc,
            n * h * h * cin + cin * nc + 8 * nc + n * h * h)


def unet_forward_ops(f: int, hw: int, nc: int) -> float:
    """Operations (2 a multiply-add) of one U-Net forward of one B-scan."""
    return sum(serving_work(k, s, 1, nc)[0] for _, k, s in stages(f, hw))


def train_convs(f: int, hw: int) -> list[tuple[str, int, int, int, str]]:
    """The 17 non-stem 3x3 convs of the U-Net: (name, H, cin, cout, setting
    that puts them on K4: "always" | "mid" | "deep")."""
    out = [("blk0_conv1", hw, f, f, "always")]
    h, c = hw // 2, f
    for i in range(1, 5):
        group = "mid" if i == 1 else "deep"
        out += [(f"blk{i}_conv0", h, c, 2 * c, group),
                (f"blk{i}_conv1", h, 2 * c, 2 * c, group)]
        h, c = h // 2, 2 * c
    for blk, h, c, group in ((5, hw // 8, 8 * f, "deep"),
                             (6, hw // 4, 4 * f, "deep"),
                             (7, hw // 2, 2 * f, "mid"),
                             (8, hw, f, "always")):
        out += [(f"blk{blk}_conv0", h, 2 * c, c, group),
                (f"blk{blk}_conv1", h, c, c, group)]
    return out


# ---------------------------------------------------------------------------
# ReLayNet (7x3 convs, index pools and unpools, 1x1 head)
# ---------------------------------------------------------------------------


def relaynet_stages(f: int, hw: int) -> list[tuple[str, int, tuple, bool]]:
    """ReLayNet's K7 calls of one forward: (name, H, cins, pool)."""
    return [("b0 stem", hw, (1,), True), ("b1", hw // 2, (f,), True),
            ("b2", hw // 4, (f,), True), ("b3", hw // 8, (f,), False),
            ("b4", hw // 4, (f, f), False), ("b5", hw // 2, (f, f), False),
            ("b6", hw, (f, f), False)]


def relaynet_work(h: int, cins: tuple, pool: bool, n: int,
                  f: int) -> tuple[float, float]:
    """(int8 ops, bytes) of one K7 call at batch n: each input read once,
    each output (with the pool: the pooled values and the indices too)
    written once."""
    cin = sum(cins)
    return (2 * n * h * h * 21 * cin * f,
            n * h * h * cin + 21 * cin * f + 8 * f
            + n * h * h * f * (1.5 if pool else 1))


def relaynet_forward_ops(f: int, hw: int, nc: int) -> float:
    """Operations of one ReLayNet forward of one B-scan: the seven 7x3
    convs and the 1x1 head."""
    convs = sum(relaynet_work(h, cins, pool, 1, f)[0]
                for _, h, cins, pool in relaynet_stages(f, hw))
    return convs + serving_work("head_argmax", (hw, f), 1, nc)[0]


# ---------------------------------------------------------------------------
# kernel bounds (the rooflines' numerators)
# ---------------------------------------------------------------------------


def unet_k1_bounds(f: int, hw: int, nc: int, n: int) -> float:
    """Sum of the least times (ms) of the U-Net's 3x3 int8 convs (K1's
    calls, the stem included) in one forward of a batch of ``n`` B-scans,
    at the int8 peak."""
    return sum(bound(*serving_work(k, s, n, nc), PEAK["int8"])[0]
               for _, k, s in stages(f, hw) if k == "conv3x3_int8")


def relaynet_k7_bounds(f: int, hw: int, n: int) -> float:
    """Sum of the least times (ms) of ReLayNet's 7x3 int8 convs (K7's
    calls) in one forward of a batch of ``n`` B-scans, at the int8 peak."""
    return sum(bound(*relaynet_work(h, cins, pool, n, f), PEAK["int8"])[0]
               for _, h, cins, pool in relaynet_stages(f, hw))
