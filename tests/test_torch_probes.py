"""The port's probe kernels M1-M3 (ops/cuda/int8_dot.py, block_parts.py,
dw_moments.py) against the JAX package's tools on the CPU, at small
shapes: M1 at rows = 2*14*14, c = 32, hid = 96; M2 and M3 at N=2, 14x14,
C=32, with no channel padding (CP = C), so that the Pallas bodies and the
port compute the same function.

The Pallas bodies are closures inside each tool's main(), so no test can
import them: each `_jax_*` function below is a jnp transcription of one,
cited line by line, with the JAX package's own helpers where the body calls
them (convnext_stage._gelu_f32, ops.conv2d). The transcriptions run
eagerly, op by op, so that each jnp operation rounds to its own dtype, as
an element of the Pallas body does. `test_cited_tool_lines_are_unchanged`
hashes the cited lines, so a tool that changes fails it until its
transcription here is checked again. Inputs come from a numpy seed. Each
comparison states its tolerance and the reason for it."""

import hashlib
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.ops import conv2d as jax_conv2d
from genconvit_tpu.ops.pallas.convnext_stage import _gelu_f32

from genconvit_tpu_torch.ops import cuda as kcuda
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda import block_parts as m2
from genconvit_tpu_torch.ops.cuda import dw_moments as m3
from genconvit_tpu_torch.ops.cuda import int8_dot as m1
from genconvit_tpu_torch.ops.cuda.convnext_block import FusedBlockWeights

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, H, C = 2, 14, 32
ROWS, HID = N * H * H, 3 * C
BF = jnp.bfloat16

# tools/<file>: the (first, last) lines transcribed below, and the sha256 of
# those lines (joined by newlines), first 16 hex digits
CITED = {
    "microbench_int8_dot.py": ([(51, 66)], "b33f63bdc2fa34dc"),
    "microbench_dwshift.py": ([(60, 68), (93, 103), (106, 108)], "56d96b6fa924f327"),
    "microbench_kernel_parts.py": ([(44, 99)], "d3efa7efd10a85b5"),
}


def test_cited_tool_lines_are_unchanged():
    for name, (spans, digest) in CITED.items():
        lines = (ROOT / "tools" / name).read_text().splitlines()
        text = "\n".join("\n".join(lines[a - 1:b]) for a, b in spans)
        assert hashlib.sha256(text.encode()).hexdigest()[:16] == digest, (
            f"tools/{name} changed at the lines this file transcribes: check the "
            f"transcription, then update the digest")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32 if a.dtype == BF else a.dtype))


def _bf16_values(a):
    """float32 values that bf16 represents (so a bf16 x f32 product is exact)."""
    return np.array(jnp.asarray(a, BF).astype(jnp.float32))


# ----------------------------------------------------------------------- M1

def _jax_dots_bf16(y, hh, w1, w2):
    """microbench_int8_dot.py:51-56 (dots_bf16_kernel), one panel = all rows."""
    c = y.shape[1]
    z = jnp.dot(y, w1, preferred_element_type=jnp.float32)            # :52-53
    o = jnp.dot(hh, w2, preferred_element_type=jnp.float32)           # :54-55
    return (o + z[:, :c]).astype(BF)                                  # :56


def _jax_dots_int8(yq, hq, wq1, s1, wq2, s2):
    """microbench_int8_dot.py:58-66 (dots_int8_kernel)."""
    c = yq.shape[1]
    z = jnp.dot(yq, wq1, preferred_element_type=jnp.int32)            # :60-61
    zf = z.astype(jnp.float32) * s1                                   # :62
    o = jnp.dot(hq, wq2, preferred_element_type=jnp.int32)            # :63-64
    of = o.astype(jnp.float32) * s2                                   # :65
    return (of + zf[:, :c]).astype(BF)                                # :66


def _m1_bf16_inputs(seed):
    """build('bf16') of microbench_int8_dot.py:70-75, JAX layout."""
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.standard_normal((ROWS, C)), BF),
            jnp.asarray(rng.standard_normal((ROWS, HID)), BF),
            jnp.asarray(rng.standard_normal((C, HID)) * .05, BF),
            jnp.asarray(rng.standard_normal((HID, C)) * .05, BF))


def _m1_int8_inputs(seed):
    """build('int8') of microbench_int8_dot.py:79-86, with scales off 1
    (the tool's ones would hide a scale applied to the wrong column)."""
    rng = np.random.default_rng(seed)

    def q(shape):
        return rng.integers(-127, 127, shape).astype(np.int8)
    return (q((ROWS, C)), q((ROWS, HID)), q((C, HID)),
            rng.uniform(0.5, 2.0, HID).astype(np.float32) / 127,
            q((HID, C)), rng.uniform(0.5, 2.0, C).astype(np.float32) / 127)


def test_m1_bf16_plain_matches_the_tool():
    """Both sum exact bf16 products in float32, in other orders: the one
    rounding of o + z may flip, so each element is within 1 bf16 ulp."""
    y, hh, w1, w2 = _m1_bf16_inputs(0)
    ref = _t(_jax_dots_bf16(y, hh, w1, w2))
    args = [_t(a).to(torch.bfloat16) for a in (y, hh)]
    lw1, lw2 = (_t(w).to(torch.bfloat16).t().contiguous() for w in (w1, w2))
    got = m1.dots_bf16_plain(*args, lw1, lw2)
    assert got.dtype == torch.bfloat16 and got.shape == (ROWS, C)
    assert m1.ulp_error(got, ref) <= 1.0
    torch.testing.assert_close(m1.dots_bf16(*args, lw1, lw2), got, rtol=0, atol=0)


def test_m1_int8_plain_matches_the_tool_exactly():
    """Exact integer sums on both sides, then the same float32 operations
    in the same order: bit for bit."""
    yq, hq, wq1, s1, wq2, s2 = _m1_int8_inputs(1)
    ref = _t(_jax_dots_int8(*(jnp.asarray(a) for a in (yq, hq, wq1, s1, wq2, s2))))
    args = [torch.from_numpy(a) for a in (yq, hq)]
    lw1, lw2 = (torch.from_numpy(w).t().contiguous() for w in (wq1, wq2))
    s1t, s2t = torch.from_numpy(s1), torch.from_numpy(s2)
    got = m1.dots_int8_plain(*args, lw1, s1t, lw2, s2t)
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=0)
    torch.testing.assert_close(m1.dots_int8(*args, lw1, s1t, lw2, s2t), got, rtol=0, atol=0)


def test_m1_planted_faults_move_the_output():
    """Each planted fault, run through the plain version, is refused by
    the check the card applies (2 ulps; int8 1 ulp)."""
    yq, hq, wq1, s1, wq2, s2 = (torch.from_numpy(a) for a in _m1_int8_inputs(2))
    lw1, lw2 = wq1.t().contiguous(), wq2.t().contiguous()
    ref = m1.dots_int8_plain(yq, hq, lw1, s1, lw2, s2)
    faults = m1.planted_faults("int8", lw1, s1, lw2)
    assert set(faults) == {"z's add dropped", "w2 transposed", "s1 by its mean"}
    for name, (b1, bs1, b2) in faults.items():
        assert m1.ulp_error(m1.dots_int8_plain(yq, hq, b1, bs1, b2, s2), ref) > m1.ULP_TOL_INT8, name
    y, hh, w1, w2 = (_t(a).to(torch.bfloat16) for a in _m1_bf16_inputs(3))
    lw1, lw2 = w1.t().contiguous(), w2.t().contiguous()
    ref = m1.dots_bf16_plain(y, hh, lw1, lw2)
    faults = m1.planted_faults("bf16", lw1, None, lw2)
    assert set(faults) == {"z's add dropped", "w2 transposed"}
    for name, (b1, _, b2) in faults.items():
        assert m1.ulp_error(m1.dots_bf16_plain(y, hh, b1, b2), ref) > m1.ULP_TOL, name


# ----------------------------------------------------------------------- M3

def _jax_shift7(x, k, b):
    """microbench_dwshift.py:93-103 (`kernel`), per image as the grid runs
    it (ipt images a step; the steps are independent). The slab is the
    input padded by 3 (shift7_fn, :107; the extra columns up to WP are TPU
    layout that no tap reads), and shifted[dx] (:91-92, a roll by -dx along
    W) read at columns 0..W-1 is the slab at columns dx..dx+W-1."""
    n, h, w, c = x.shape
    slab = jnp.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))                # :107
    acc = jnp.broadcast_to(b.astype(jnp.float32), (n, h, w, c))        # :93
    for dy in range(7):                                                # :94
        for dx in range(7):                                            # :95
            tap = slab[:, dy:dy + h, dx:dx + w, :]                     # :96
            acc = acc + tap.astype(jnp.float32) * k[dy, dx, :]         # :97
    dw = acc.astype(x.dtype)                                           # :98
    inv_c = jnp.float32(1.0 / c)                                       # :99
    mu = jnp.sum(acc, axis=-1) * inv_c                                 # :100
    var = jnp.sum(jnp.square(acc), axis=-1) * inv_c - jnp.square(mu)   # :101
    return dw, mu, var                                                 # :102-103


def _jax_xla_fn(x, k, b):
    """microbench_dwshift.py:60-68 (xla_fn), the tool's yardstick."""
    c = x.shape[-1]
    dw = jax_conv2d(x, k[:, :, None, :].transpose(0, 1, 2, 3).reshape(7, 7, 1, c)  # :61-64
                    .astype(x.dtype), b, padding=3, groups=c)
    x32 = dw.astype(jnp.float32)                                       # :65
    mu = jnp.mean(x32, axis=-1, keepdims=True)                         # :66
    var = jnp.mean(jnp.square(x32), axis=-1, keepdims=True) - jnp.square(mu)  # :67
    return dw, mu[..., 0], var[..., 0]                                 # :68


def _m3_inputs(seed):
    """The tool's inputs (:57-58, :142) at the small shape; the weights
    bf16-representable (see dw_moments_plain)."""
    rng = np.random.default_rng(seed)
    k = _bf16_values(rng.standard_normal((7, 7, C)) * 0.05)
    b = (rng.standard_normal((C,)) * 0.05).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((N, H, H, C)), BF)
    return x, k, b


def _port(x, k, b):
    return _t(x).to(torch.bfloat16), torch.from_numpy(k), torch.from_numpy(b)


def test_m3_plain_matches_the_pallas_body():
    """dw: the same exact products summed in the same (dy, dx) order from
    the bias, so bit for bit. mean and var: the sums over C run in other
    orders, within dw_moments.MOMENT_TOL of their scales (f32 noise)."""
    x, k, b = _m3_inputs(4)
    ref = tuple(_t(a) for a in _jax_shift7(x, jnp.asarray(k), jnp.asarray(b)))
    got = m3.dw_moments_plain(*_port(x, k, b))
    assert got[0].dtype == torch.bfloat16 and got[1].shape == got[2].shape == (N, H, H)
    torch.testing.assert_close(got[0].float(), ref[0], rtol=0, atol=0)
    err = m3.ulp_error(got, ref)
    assert m3.agrees(err), err
    wrapped = m3.dw_moments(*_port(x, k, b))
    for a, g in zip(wrapped, got):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


def test_m3_library_is_the_tools_yardstick_and_the_gap_is_the_rounding():
    """dw_moments_library (the depthwise conv + moments of the rounded dw)
    against the tool's xla_fn: both convs sum in float32 and round once,
    but ops.conv2d adds the bias to the rounded conv and rounds again,
    where torch's conv adds it before its one rounding. Where the bias
    cancels the conv, that first rounding (half an ulp of |conv|) is many
    ulps of the small result, so dw is held to one bf16 ulp of max|dw|,
    and the moments of the two dw to 2^-7 of their scales. The gap
    between those moments and the kernel's (of the f32 sums) is the
    rounding of dw: each element moves by at most 2^-9 of itself, so the
    mean by at most 2^-9 and var by at most 2^-7 of mean(dw^2) times the
    pixel's share of the scale; it is reported, not held to 0."""
    x, k, b = _m3_inputs(5)
    ref = tuple(_t(a) for a in _jax_xla_fn(x, jnp.asarray(k), jnp.asarray(b)))
    lib = m3.dw_moments_library(*_port(x, k, b))
    top = ref[0].abs().max().item()
    assert (lib[0].float() - ref[0]).abs().max().item() <= 2.0 ** (math.floor(math.log2(top)) - 7)
    mu_s, sq_s = m3.moment_scales(ref[0])
    assert (lib[1] - ref[1]).abs().max().item() / mu_s <= 2 ** -7
    assert (lib[2] - ref[2]).abs().max().item() / sq_s <= 2 ** -7
    dw, mean, var = m3.dw_moments_plain(*_port(x, k, b))
    gap_mean, gap_var = m3.moments_rounding_gap(dw, mean, var)
    assert 0 < gap_mean <= 2 ** -6 and 0 < gap_var <= 2 ** -5


def test_m3_planted_faults_are_refused():
    x, k, b = _port(*_m3_inputs(6))
    ref = m3.dw_moments_plain(x, k, b)
    for name, (bk, bb) in m3.planted_faults(k, b).items():
        assert not m3.agrees(m3.ulp_error(m3.dw_moments_plain(x, bk, bb), ref)), name
    bad = (ref[0], ref[1], m3.var_without_mean_sq(ref[1], ref[2]))
    err = m3.ulp_error(bad, ref)
    assert err["var_rel"] > m3.MOMENT_TOL and not m3.agrees(err)


# ----------------------------------------------------------------------- M2

def _jax_kern(xp, args, phase, fp32dw=True):
    """microbench_kernel_parts.py:44-99 (`kern`) over all images at once
    (the grid's steps are independent images; the DMA of :49-61 stages
    image i's padded slab, here xp[i]). CP = C: no channel padding, so
    inv_c = 1 / C of :76 divides by the channels that exist."""
    dwk, dwb, lns, lnb, w1, b1, w2, b2, gam = args
    n, hp, wp, cp = xp.shape
    h, w = hp - 6, wp - 6
    cur = xp
    if phase == "dma":                                                 # :63
        return cur[:, 3:3 + h, 3:3 + w, :]                             # :64
    accdt = jnp.float32 if fp32dw else BF                              # :66
    acc = jnp.broadcast_to(dwb[:].astype(accdt), (n, h, w, cp))        # :67
    for dy in range(7):                                                # :68
        for dx in range(7):                                            # :69
            acc = acc + cur[:, dy:dy + h, dx:dx + w, :].astype(accdt) \
                * dwk[dy, dx].astype(accdt)                            # :70-71
    if phase == "dw":                                                  # :72
        return acc.astype(BF)                                          # :73
    acc = acc.astype(jnp.float32)                                      # :75
    inv_c = jnp.float32(1.0 / cp)                                      # :76
    mean = jnp.sum(acc, axis=-1, keepdims=True) * inv_c                # :77
    var = jnp.sum(jnp.square(acc), axis=-1, keepdims=True) * inv_c \
        - jnp.square(mean)                                             # :78-79
    y = (acc - mean) * jax.lax.rsqrt(var + 1e-6)                       # :80 (EPS, :42)
    y = y * lns[:].astype(jnp.float32) + lnb[:].astype(jnp.float32)    # :81
    if phase == "ln":                                                  # :82
        return y.astype(BF)                                            # :83
    y2 = y.reshape(n * h * w, cp).astype(BF)                           # :85
    hid = jnp.dot(y2, w1[:], preferred_element_type=jnp.float32)       # :86
    hid = hid + b1[:].astype(jnp.float32)                              # :87
    if phase == "fc1":                                                 # :88
        return hid[:, :cp].reshape(n, h, w, cp).astype(BF)             # :89
    # :91; the TPU's approximate reciprocal has no CPU lowering, so the exact
    # divide, as the JAX package's interpret-mode tests run it
    hid = _gelu_f32(hid, exact_div=True).astype(BF)
    if phase == "gelu":                                                # :92
        return hid[:, :cp].reshape(n, h, w, cp).astype(BF)             # :93
    o = jnp.dot(hid, w2[:], preferred_element_type=jnp.float32)        # :95
    o = (o + b2[:].astype(jnp.float32)).reshape(n, h, w, cp)           # :96
    o = o * gam[:].astype(jnp.float32)                                 # :97
    res = cur[:, 3:3 + h, 3:3 + w, :].astype(jnp.float32)              # :98
    return (res + o).astype(BF)                                        # :99


def _m2_inputs(seed):
    """The tool's inputs (:119-128) at the small shape: the depthwise
    weights bf16-representable (the probe reads K5's bf16 pack)."""
    rng = np.random.default_rng(seed)

    def mk(shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((N, H, H, C)), BF)
    e = 4 * C
    args = (_bf16_values(mk((7, 7, C))), mk((C,)), mk((C,), 1.0), mk((C,)),
            jnp.asarray(rng.standard_normal((C, e)) * .05, BF), mk((e,)),
            jnp.asarray(rng.standard_normal((e, C)) * .05, BF), mk((C,)), mk((C,), 0.5))
    dwk, dwb, lns, lnb, w1, b1, w2, b2, gam = args
    pack = FusedBlockWeights(
        w_dw=torch.from_numpy(dwk.reshape(49, C)).to(torch.bfloat16),
        b_dw=torch.from_numpy(dwb), ln_scale=torch.from_numpy(lns),
        ln_bias=torch.from_numpy(lnb), w1=_t(w1).to(torch.bfloat16),
        b1=torch.from_numpy(b1), w2=_t(w2).to(torch.bfloat16), b2=torch.from_numpy(b2),
        gamma=torch.from_numpy(gam))
    xp = jnp.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))                  # :122-123, CP = C
    return xp, tuple(jnp.asarray(a) for a in args), _t(x).to(torch.bfloat16), pack


# (phase, the tool's fp32dw, ulps allowed): dma, dw, dw_bf16acc: bit for bit
# (a copy; the same exact products, or the same bf16 roundings, in the same
# order); ln: the LN statistics summed in another order, f32 noise that can
# flip one rounding of y (1 ulp); fc1, gelu: that and the fc1 sums in
# another order (2 ulps, floor max|ref| / 128); full: K5's bound (2 ulps of
# max(|ref|, |x|), floored at the block's largest change)
@pytest.mark.parametrize("phase,fp32dw,ulps", [
    ("dma", True, 0.0), ("dw", True, 0.0), ("dw_bf16acc", False, 0.0), ("ln", True, 1.0),
    ("fc1", True, 2.0), ("gelu", True, 2.0), ("full", True, 2.0)])
def test_m2_plain_matches_the_pallas_body(phase, fp32dw, ulps):
    xp, args, x, pack = _m2_inputs(7)
    ref = _t(_jax_kern(xp, args, "dw" if phase == "dw_bf16acc" else phase, fp32dw))
    got = m2.block_parts_plain(x, pack, phase)
    assert got.dtype == torch.bfloat16 and got.shape == (N, H, H, C)
    if ulps == 0.0:
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=0)
    else:
        assert m2.ulp_error(got, ref, x, phase) <= ulps
    torch.testing.assert_close(m2.block_parts(x, pack, phase), got, rtol=0, atol=0)


@pytest.mark.parametrize("phase", m2.PHASES)
def test_m2_planted_faults_are_refused(phase):
    _, _, x, pack = _m2_inputs(8)
    ref = m2.block_parts_plain(x, pack, phase)
    faults = m2.planted_faults(pack, phase)
    assert len(faults) == {"dma": 0, "dw": 2, "dw_bf16acc": 2}.get(phase, 3)
    for name, bad in faults.items():
        assert m2.ulp_error(m2.block_parts_plain(x, bad, phase), ref, x, phase) > m2.ULP_TOL, name


# ------------------------------------------------------------ the wrappers

def test_probe_wrappers_take_the_plain_path_on_cpu_and_refuse_other_devices():
    """On CPU tensors each wrapper runs its plain version, launches nothing
    and builds nothing; on a device with no kernel it raises."""
    kcuda.reset_launch_counts()
    _, _, x, pack = _m2_inputs(9)
    m2.block_parts(x, pack, "ln")
    k, b = torch.zeros(7, 7, C), torch.zeros(C)
    m3.dw_moments(x, k, b)
    y = torch.zeros(8, C, dtype=torch.bfloat16)
    m1.dots_bf16(y, torch.zeros(8, HID, dtype=torch.bfloat16),
                 torch.zeros(HID, C, dtype=torch.bfloat16), torch.zeros(C, HID, dtype=torch.bfloat16))
    assert set(kcuda.launch_counts().values()) == {0}
    assert not _build.is_loaded()
    with pytest.raises(ValueError, match="phase"):
        m2.block_parts(x, pack, "fc2")
    meta = torch.empty(1, 7, 7, C, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        m2.block_parts(meta, pack, "full")
    with pytest.raises(ValueError, match="unsupported device"):
        m3.dw_moments(meta, k, b)
    ym = torch.empty(8, C, device="meta", dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        m1.dots_int8(ym, ym, ym, ym, ym, ym)
    with pytest.raises(ValueError, match="unsupported device"):
        m1.dots_bf16(meta, meta, meta, meta)


@pytest.mark.parametrize("tool,args", [
    ("microbench_int8_dot", ["--shape", "2,7,32", "--hid", "128", "--trials", "1"]),
    ("microbench_dwshift", ["--n", "2", "--h", "7", "--c", "32", "--iters", "1"]),
    ("microbench_kernel_parts", ["--n", "2", "--h", "7", "--c", "32", "--iters", "1"])])
def test_tools_run_on_the_cpu(tool, args, capsys):
    """Each tool runs end to end on the CPU (plain versions, host clock,
    said so) and passes its own parity checks."""
    import importlib

    mod = importlib.import_module(f"genconvit_tpu_torch.tools.{tool}")
    assert mod.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "host clock on the CPU" in out and "ms" in out
    assert not _build.is_loaded()
