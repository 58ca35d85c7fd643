"""The port's sharded evaluation (genconvit_tpu_torch/parallel/) on the CPU:
four gloo ranks, spawned once for the module (tests/torch_parallel_ranks.py
`eval_rank`), against the JAX package's predict_sharded and
predict_long_video on a mesh of four of the conftest's virtual devices,
and against the port's own unsharded forward. Small models: ConvNeXt
depths (1,1,1,1), dims (8..64), 64 px, weights bridged from the JAX trees,
deterministic VAE as tests/test_parallel.py runs it. Bounds: y equal; y_val
within 1e-5 of JAX (tests/test_torch_engine.py's) and within 1e-6 of the
unsharded port (only the batch of each forward differs)."""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import jax

from genconvit_tpu.config import Config as JaxConfig
from genconvit_tpu.infer.engine import Predictor as JaxPredictor
from genconvit_tpu.parallel import eval_shard as jax_shard
from genconvit_tpu.parallel.mesh import make_mesh as jax_mesh
from genconvit_tpu.parallel.mesh import shard_batch as jax_shard_batch

from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.parallel import eval_shard
from genconvit_tpu_torch.parallel.dryrun import Ranks
from genconvit_tpu_torch.parallel.multihost import LAUNCHER_ENV, initialize_multihost

from tests import torch_parallel_ranks as ranks
from tests.test_torch_util import IMG, ed_state_dict, jax_trees, vae_state_dict

WORLD = 4
V, F = 5, 3
F_LONG, TAIL = 21, 2
PATHS = [f"v{i}.mp4" for i in range(10)]
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, each rank's results, JAX's results per net)."""
    tmp = tmp_path_factory.mktemp("parallel_eval")
    rng = np.random.default_rng(0)
    trees = jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))
    for b in trees:   # decisive verdicts, as tests/test_torch_util.write_gcv_weights makes them
        trees[b]["fc2"] = {k: np.asarray(v) * 10.0 for k, v in trees[b]["fc2"].items()}
    masks = np.ones((V, F), np.float32)
    masks[1, 2:] = 0
    masks[3, 1:] = 0
    fmask = np.ones((F_LONG,), np.float32)
    fmask[-TAIL:] = 0
    d = {"sds": {b: {k: v.numpy() for k, v in state_dict_from_jax(trees[b], b).items()}
                 for b in trees},
         "faces": rng.integers(0, 256, (V, F, IMG, IMG, 3), np.uint8), "masks": masks,
         "frames": rng.integers(0, 256, (F_LONG, IMG, IMG, 3), np.uint8), "fmask": fmask,
         "prefix": F_LONG - TAIL, "paths": PATHS}
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(d))
    job = Ranks(ranks.eval_rank, WORLD, str(inputs))   # the JAX side meanwhile
    jcfg = JaxConfig()
    jcfg.img_size = IMG
    jcfg.model.latent_dims = jcfg.derived_latent_dims()
    mesh = jax_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    want = {}
    for net in ("ed", "genconvit"):
        params = {b: trees[b] for b in ("ed", "vae") if net in (b, "genconvit")}
        jp = JaxPredictor(jcfg, net=net, params=params, deterministic_vae=True,
                          face_backend="fullframe")
        want[net] = {"sharded": jax_shard.predict_sharded(jp, d["faces"], masks, mesh),
                     "long": jax_shard.predict_long_video(jp, d["frames"], fmask, mesh)}
    return d, job.join(timeout=300), want


@pytest.mark.parametrize("net", ["ed", "genconvit"])
def test_predict_sharded_matches_jax_and_the_unsharded_port(runs, net):
    _, got, want = runs
    y_j, v_j = (np.asarray(a) for a in want[net]["sharded"])
    y_u, v_u = got[0][net]["unsharded"]
    for r in got:
        y, y_val = r[net]["sharded"]
        assert y.shape == y_val.shape == (V,)
        np.testing.assert_array_equal(y, y_j)
        np.testing.assert_allclose(y_val, v_j, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(y, y_u)
        np.testing.assert_allclose(y_val, v_u, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(r[net]["again"][1], y_val)
    assert len(set(v_j.tolist())) == V, "every video's verdict its own"


@pytest.mark.parametrize("net", ["ed", "genconvit"])
def test_rotated_gather_is_caught(runs, net):
    """A planted fault: every block gathered one rank along."""
    _, got, _ = runs
    y_u, v_u = got[0][net]["unsharded"]
    y, y_val = got[0][net]["rotated"]
    assert not np.allclose(y_val, v_u, rtol=0, atol=1e-6)


@pytest.mark.parametrize("net", ["ed", "genconvit"])
def test_long_video_matches_jax_and_the_unsharded_port(runs, net):
    _, got, want = runs
    y_j, v_j = want[net]["long"]
    y_u, v_u = got[0][net]["long_unsharded"]
    for r in got:
        y, v = r[net]["long"]
        assert y == y_j == int(y_u[0])
        np.testing.assert_allclose(v, v_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(v, float(v_u[0]), rtol=0, atol=1e-6)
        # the zeroed tail scores as the prefix alone (tests/test_parallel.py:132-144)
        y_p, v_p = r[net]["prefix"]
        assert y_p == y
        np.testing.assert_allclose(v_p, v, rtol=1e-6, atol=1e-7)


def test_broadcast_runs_once_per_mesh_and_replicates(runs):
    _, got, _ = runs
    for r in got:
        for net in ("ed", "genconvit"):
            # two predict_sharded calls, three predict_long_video calls, one rotated
            assert r[net]["broadcasts"] == 1 and r[net]["cached"] == 1
    before = {r["replica"][0] for r in got}
    after = {r["replica"][1] for r in got}
    assert len(before) == WORLD and len(after) == 1
    assert got[0]["replica"][1] == got[0]["replica"][0]   # the first rank's weights
    for r in got[1:]:
        for a, b in zip(r["replica"][2], got[0]["replica"][2]):
            np.testing.assert_array_equal(a, b)


def test_sampling_ranks_draw_their_own_eps(runs):
    """One video on every rank: with the VAE sampling, each rank's verdict
    differs (its own eps); deterministic, all agree."""
    _, got, _ = runs
    for r in got:
        assert len(set(r["sampled"].tolist())) == WORLD
        assert len(set(r["deterministic"].tolist())) == 1
        np.testing.assert_array_equal(r["sampled"], got[0]["sampled"])


def test_shard_file_list_matches_jax(runs):
    _, got, _ = runs
    for pc in range(1, 6):
        for pi in range(pc):
            assert eval_shard.shard_file_list(PATHS, pi, pc) == \
                jax_shard.shard_file_list(PATHS, pi, pc)
    for rank, r in enumerate(got):
        assert r["files"] == jax_shard.shard_file_list(PATHS, rank, WORLD)


def test_shard_batch_is_p_data(runs):
    """This rank's contiguous block in rank order: the rows JAX's
    shard_batch puts on device i; an uneven batch's first ranks take one
    row more."""
    _, got, _ = runs
    mesh = jax_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    rows = jax_shard_batch(np.arange(2 * WORLD), mesh)
    want = {s.device: np.asarray(s.data) for s in rows.addressable_shards}
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["blocks"][0], want[mesh.devices.flat[rank]])
    uneven = np.concatenate([r["blocks"][1] for r in got])
    np.testing.assert_array_equal(uneven, np.arange(2 * WORLD + 2))
    assert [len(r["blocks"][1]) for r in got] == [3, 3, 2, 2]


def test_mesh_shapes_and_refusals(runs):
    """A 3x2 mesh of four ranks is refused; tensor parallelism on the 4x1
    mesh (a 'model' axis of one: the split leaves every tensor whole) and a
    2x2 mesh without it (weights replicated over 'model') run, and give the
    data-parallel verdicts."""
    _, got, _ = runs
    for r in got:
        assert r["mesh_shape"] == (WORLD, 1) and r["mesh2_shape"] == (WORLD // 2, 2)
        e = r["runs"]
        assert e["3x2"][0] == "ValueError"
        y, v = e["dp"]
        for what in ("tp", "model2"):
            np.testing.assert_array_equal(e[what][0], y)
            np.testing.assert_allclose(e[what][1], v, rtol=0, atol=1e-6)
        assert e["model2_long"][0] == e["long"][0]
        np.testing.assert_allclose(e["model2_long"][1], e["long"][1], rtol=0, atol=1e-6)
        assert e["tp_params"] and e["model2_params"]


def test_initialize_multihost(monkeypatch, tmp_path):
    """Without the launcher's environment: False, and no process group; with
    it (world 1, gloo, a file store), in a fresh process: initialized."""
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is False
    assert not dist.is_initialized()
    code = ("import torch.distributed as d\n"
            "from genconvit_tpu_torch.parallel.multihost import initialize_multihost\n"
            f"ok = initialize_multihost({('file://' + str(tmp_path / 'store'))!r}, "
            "backend='gloo')\n"
            "print(ok, d.get_world_size(), d.get_rank(), d.get_backend())\n"
            "d.destroy_process_group()\n")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == ["True", "1", "0", "gloo"]
