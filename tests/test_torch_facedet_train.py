"""The detector's training (genconvit_tpu_torch/train/facedet_train.py)
against the JAX package's on the CPU: make_facedet_train_step over two
Adam steps from the JAX package's init (loss, box loss and parameters
within 1e-4 relative: the same float32 graph, summed in other orders),
assign_targets equal, and the cosine schedule against optax's (1e-6)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from genconvit_tpu.models.facedet import init_facedet
from genconvit_tpu.train import facedet_train as jax_fd

from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models.facedet import FaceDet
from genconvit_tpu_torch.train import facedet_train as fd


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_facedet_train_step_matches_jax():
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(np.asarray, init_facedet(jax.random.PRNGKey(0)))
    imgs = rng.integers(0, 256, (4, 128, 128, 3), np.uint8)
    boxes = [[[0.3, 0.4, 0.2, 0.25]], [[0.6, 0.5, 0.5, 0.45], [0.2, 0.2, 0.1, 0.1]],
             [[0.5, 0.5, 0.8, 0.7]], []]
    targets = [fd.assign_targets(b) for b in boxes]
    for (lab, reg), b in zip(targets, boxes):
        want = jax_fd.assign_targets(b)
        np.testing.assert_array_equal(lab, want[0])
        np.testing.assert_array_equal(reg, want[1])
    lab, reg = np.stack([t[0] for t in targets]), np.stack([t[1] for t in targets])
    tx = optax.adam(1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    jstep = jax_fd.make_facedet_train_step(tx)
    model = FaceDet()
    model.load_state_dict(state_dict_from_jax(tree, "facedet"))
    step = fd.make_facedet_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    for _ in range(2):
        params, state, jloss, jaux = jstep(params, state, jnp.asarray(imgs), jnp.asarray(lab),
                                           jnp.asarray(reg))
        loss, aux = step(torch.from_numpy(imgs), torch.from_numpy(lab), torch.from_numpy(reg))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(float(aux["box"]), float(jaux["box"]), rtol=1e-4)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), "facedet")
    assert _rel(np.concatenate([got[k].ravel() for k in sorted(got)]),
                np.concatenate([want[k].numpy().ravel() for k in sorted(got)])) < 1e-4
    sched, ref = fd.cosine_decay(1e-3, 10), optax.cosine_decay_schedule(1e-3, 10, alpha=0.01)
    np.testing.assert_allclose([sched(t) for t in range(14)], [float(ref(t)) for t in range(14)],
                               rtol=1e-6)
