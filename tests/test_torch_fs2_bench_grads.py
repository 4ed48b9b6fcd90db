"""FastSpeech2's loss gradients at ``bench.py``'s widths (adim 384, 4
heads, 4 + 4 layers, eunits and dunits 1,536; every other hyperparameter
the models' default) against the JAX package's, on the CPU.

The weights are drawn with numpy and loaded into both packages through the
bridge, every dropout rate 0 and the Postnet's BatchNorm on batch
statistics, as tests/test_torch_fs2_train.py's small-width case does; the
batch is two utterances of 12 and 9 phones over 128 and 101 frames.  Each
parameter's gradient of the masked loss (dense attention, float32) is held
to the JAX gradient within the golden ``fastspeech2_grads`` check's
tolerance (``tools/golden/run_parity.py``, tests/
test_torch_golden_parity.py: 1e-3 max abs difference), taken relative to
the gradient's largest magnitude where that exceeds 1: at these widths
the random targets give gradients up to ~7e3, where float32 rounding
alone reaches 1e-3 (measured on the CPU: 2e-3 at most, 7.3e-6 of the
range).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np

from parakeet_tpu.models.fastspeech2 import FastSpeech2 as JFS2
from parakeet_tpu.models.fastspeech2 import fastspeech2_loss as j_loss
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import FastSpeech2, fastspeech2_loss
from test_torch_fs2_train import (BATCH_KEYS, NO_DROPOUT, _batch,
                                  _jax_apply, _randomize, _torch_batch)

# bench.py:41
BENCH = dict(idim=80, odim=80, adim=384, aheads=4, elayers=4, eunits=1536,
             dlayers=4, dunits=1536)
TOL = 1e-3


def test_gradients_at_bench_widths_match_jax():
    batch = _batch((12, 9), (128, 101), 7, odim=BENCH["odim"])
    jm = JFS2(attn_impl="dense", **BENCH, **NO_DROPOUT)
    v = jax.jit(lambda k: jm.init(
        {"params": k}, *[jnp.asarray(batch[n]) for n in BATCH_KEYS],
        deterministic=False))(jax.random.PRNGKey(0))
    flat = _randomize(flatten_tree(v), 5)
    variables = nest_flat(flat)
    tm = FastSpeech2(attn_impl="dense", **BENCH, **NO_DROPOUT)
    load_flax_params(tm, flat)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}

    def loss_fn(params):
        outputs, mutated = _jax_apply(jm, variables, batch, params)
        return j_loss(outputs, jbatch)["loss"], mutated["batch_stats"]

    (want_loss, stats), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tb = _torch_batch(batch)
    loss = fastspeech2_loss(tm(*[tb[k] for k in BATCH_KEYS],
                               deterministic=False), tb)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = copy.deepcopy(tm)
    load_flax_params(want, flatten_tree({"params": want_g,
                                         "batch_stats": stats}))
    wanted = dict(want.named_parameters())
    worst, n = 0.0, 0
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        err = (p.grad - wanted[name].detach()).abs().max().item()
        scale = max(1.0, wanted[name].detach().abs().max().item())
        assert err <= TOL * scale, (name, err, scale)
        worst, n = max(worst, err / scale), n + p.numel()
    print(f"{n} parameters; largest gradient difference {worst:.3e} of "
          "the gradient's range")
    assert worst > 0
