"""FastSpeech2's tone embeddings in the PyTorch port against the JAX
package: ``num_tones``, ``tone_embed_dim`` and both integrations ('add':
the projected, L2-normalised per-token embedding added to the encoder's
output; 'concat': the projection of [encoder output, embedding]).

Weights are drawn with numpy and loaded into both packages through the
bridge; dropout is off and BatchNorm runs on batch statistics, as in a
train step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models.fastspeech2 import FastSpeech2 as JFS2
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import FastSpeech2
from test_torch_fs2_train import (BATCH_KEYS, CFG, NO_DROPOUT, T_TEXT, TOL,
                                  _batch, _randomize)

torch.set_num_threads(1)

N_TONES = 6


@pytest.mark.parametrize("integration", ["add", "concat"])
def test_tone_embedding_matches_jax(integration):
    """The teacher-forced forward and ``inference`` with ``tone_id``
    (padding tokens carry tone 0): every output within the FastSpeech2
    tests' float32 tolerance; the tone changes the output."""
    batch = _batch((12, 9), (128, 101), 5)
    rng = np.random.default_rng(6)
    tone_id = rng.integers(0, N_TONES, (2, T_TEXT))
    tone_id[1, 9:] = 0
    kw = dict(num_tones=N_TONES, tone_embed_dim=5,
              tone_embed_integration_type=integration)
    jm = JFS2(attn_impl="dense", **CFG, **NO_DROPOUT, **kw)
    args = [jnp.asarray(batch[n]) for n in BATCH_KEYS]
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k}, *args, tone_id=jnp.asarray(tone_id),
        deterministic=False), jax.random.PRNGKey(0))
    flat = _randomize(flatten_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)), 7)
    assert "params::tone_projection::kernel" in flat
    tm = FastSpeech2(attn_impl="dense", **CFG, **NO_DROPOUT, **kw)
    load_flax_params(tm, flat)          # raises on anything unmapped
    assert tm.tone_projection.in_features == (
        5 + CFG["adim"] if integration == "concat" else 5)
    # inference first: the training forward updates the port's running
    # BatchNorm statistics in place
    infer = jax.jit(lambda v: jm.apply(
        v, args[0], args[1], max_frames=64, tone_id=jnp.asarray(tone_id),
        min_duration=1, method=JFS2.inference))(nest_flat(flat))
    tb = [torch.from_numpy(np.asarray(batch[n])) for n in BATCH_KEYS]
    with torch.no_grad():
        got_i = tm.inference(tb[0], tb[1], max_frames=64,
                             tone_id=torch.from_numpy(tone_id),
                             min_duration=1)
        untoned = tm.inference(tb[0], tb[1], max_frames=64, min_duration=1)
    np.testing.assert_allclose(got_i["after_outs"].numpy(),
                               np.asarray(infer["after_outs"]), **TOL)
    want, _ = jax.jit(lambda v: jm.apply(
        v, *args, tone_id=jnp.asarray(tone_id), deterministic=False,
        mutable=["batch_stats"]))(nest_flat(flat))
    got = tm(*tb, tone_id=torch.from_numpy(tone_id), deterministic=False)
    for key in ("before_outs", "after_outs", "d_outs", "p_outs", "e_outs"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), err_msg=key, **TOL)
    assert not torch.equal(got_i["after_outs"], untoned["after_outs"])


def test_unknown_tone_integration_raises():
    with pytest.raises(ValueError, match="tone_embed_integration_type"):
        FastSpeech2(idim=10, odim=8, adim=32, aheads=2,
                    tone_embed_integration_type="sum")
