"""bfloat16 training compute (``model.backbone.dtype``) of the reference's
MSDA + points + split model and of the Swin-T model in the PyTorch port
against the JAX package's bfloat16 model and loss on the CPU, by forward
and loss: tests/test_torch_train_bf16.py's models and rule
(``_within_bf16``: the port's distance to JAX's bfloat16 result at most
twice JAX's own distance to the port's float32 result plus 1e-2 of
scale), the loss also to 1e-2 relative, under the assignment JAX's loss
made. Points mode replays JAX's draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

from test_torch_train import B
from test_torch_train_bf16 import (_batch, _init, _jax_assignment,
                                   _jax_loss_fn, _port_first, _port_trainer,
                                   _within_bf16, one_thread)  # noqa: F401


def _msda(m):
    from test_torch_points import _tiny as points_tiny

    return points_tiny(m)


def _swin(m):
    from test_torch_swin import _tiny as swin_tiny

    return swin_tiny(m)


@pytest.mark.parametrize("model", ["msda_points_split", "swin"])
def test_bf16_forward_and_loss_of_other_models(model):
    """Each model's predictions, and its loss and logs under JAX's
    assignment, in bfloat16 against JAX's (the float32 reference: the
    port's float32 forward and loss)."""
    from test_torch_points import jax_draws

    build = _msda if model == "msda_points_split" else _swin
    jc = build(jcfg)
    variables = _init(jc)
    batch = _batch()
    loss, (logs, cls, masks) = jax.jit(_jax_loss_fn(jc, jnp.bfloat16))(
        variables["params"], variables.get("batch_stats", {}), batch)
    assigned = _jax_assignment(jc, cls, masks, batch)
    points = jc.num_points if jc.loss_sampling == "points" else 0
    draws = (jax_draws(jax.random.PRNGKey(0), cls.shape[0], B, jc.num_queries,
                       points)[1:] if points else [])
    bf, ref = (_port_first(_port_trainer(build(tcfg), variables, bf16),
                           assigned, draws) for bf16 in (True, False))
    assert bf["cls_dtype"] == torch.bfloat16 and bf["masks_dtype"] == torch.float32
    _within_bf16(bf["cls"], np.asarray(cls, np.float32), ref["cls"], "cls")
    _within_bf16(bf["masks"], np.asarray(masks), ref["masks"], "masks")
    np.testing.assert_allclose(bf["loss"], float(loss), rtol=1e-2)
    for k, v in logs.items():
        _within_bf16(bf["logs"][k], float(v), ref["logs"][k], k)
