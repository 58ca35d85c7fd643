"""The port's on-card parity sweep (genconvit_tpu_torch/tools/onchip_parity.py)
on the CPU, where each fast path is its plain version: every check of the
JAX tool's sweep (and K2's and K3's) prints PASS and the tool exits 0; a
planted fault makes it exit 1; and its reference, `block_reference`, is the
JAX package's `_block_xla` on the same bf16 weights at stage 3's shape,
with the exact-erf GELU and with the default rational one (within 1e-2 of
max|ref|: the two bf16 graphs round at the same points and differ in float
summation order; measured 3.18e-03 for both, a bf16 unit in the last
place of the largest outputs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genconvit_tpu.models.convnext import _block_xla
from genconvit_tpu.ops.kernel_plan import KernelPlan, plan_scope

from genconvit_tpu_torch.models.convnext import _nchw, _nhwc, block_reference
from genconvit_tpu_torch.tools import onchip_parity as op

BLOCK_TOL = 1e-2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the sweep's many mid-sized bf16 ops slow down
    tenfold when the test workers' thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _names(lines, verdict):
    return [ln.split(": max rel diff")[0][len(verdict) + 1:] for ln in lines
            if ln.startswith(verdict + " ")]


def test_sweep_passes_every_check_on_the_cpu(capsys):
    assert op.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    passed = _names(lines, "PASS")
    assert not _names(lines, "FAIL")
    want = []
    for si, h, c in op.STAGES:
        tag = f"s{si} [{h}x{h}x{c}]"
        want += [f"{name} {tag}" for name in ("folded_block", "pallas_mlp", "pallas_mlp_int8full",
                                               "pallas_mlp_int8fc1", "pallas_mlp_padded_stage")]
        want += [f"pallas_block {tag}"] if h >= 28 else []
        want += [f"pallas_stage {tag}"] if c % 128 == 0 else []
    want += ["window_attention plain", "window_attention shifted", "rational_gelu bf16",
             "layer_norm_rows", "matmul_wint8 [M=120, K=3136, N=1568]"]
    assert sorted(passed) == sorted(want)
    assert len(passed) == 29
    assert lines[-1] == "all on-chip parity checks passed"


def test_a_planted_fault_fails_the_sweep(capsys):
    assert op.main(["--device", "cpu", "--plant", "k6-layer-scale"]) == 1
    failed = _names(capsys.readouterr().out.splitlines(), "FAIL")
    assert failed == ["pallas_stage s2 [14x14x384]", "pallas_stage s3 [7x7x768]"]


def test_unknown_plant_and_missing_card_are_refused():
    with pytest.raises(ValueError, match="unknown plant"):
        op.run(torch.device("cpu"), "k9-nothing")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            op.main([])


@pytest.mark.parametrize("tier", ["exact", "default"])
def test_block_reference_is_the_jax_block_xla(tier):
    si, h, c = op.STAGES[3]
    blk = op.stage_blocks(torch.device("cpu"))[si]
    t = blk.tensors()

    def leaf(v):   # bf16 to bf16: the same values
        return jnp.asarray(v.detach().float().numpy(), jnp.bfloat16)

    p = {"conv_dw": {"kernel": leaf(t.dw_weight.permute(2, 3, 1, 0)), "bias": leaf(t.dw_bias)},
         "norm": {"scale": leaf(t.ln_weight), "bias": leaf(t.ln_bias)},
         "mlp": {"fc1": {"kernel": leaf(t.fc1_weight.t()), "bias": leaf(t.fc1_bias)},
                 "fc2": {"kernel": leaf(t.fc2_weight.t()), "bias": leaf(t.fc2_bias)}},
         "gamma": leaf(t.gamma)}
    x = np.random.default_rng(5).standard_normal((op.BATCH, h, h, c)).astype(np.float32)
    with plan_scope(dataclasses.replace(KernelPlan(), gelu=tier)):
        want = np.asarray(jax.jit(_block_xla)(p, jnp.asarray(x, jnp.bfloat16)), np.float32)
    xt = _nchw(torch.from_numpy(x).to(torch.bfloat16)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = _nhwc(block_reference(xt, t, tier)).float().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= BLOCK_TOL, rel
