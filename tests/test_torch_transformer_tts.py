"""TransformerTTS of the PyTorch port against the JAX package: the decoder
layer with and without its KV cache, the model teacher-forced and
free-running at r = 1 and 2, both losses, one Adam train step whose state
crosses the bridge both ways, GST (2-D convolutions, BatchNorm on running
statistics, the GRU) and the batch function.

Weights are drawn with numpy into the flax tree and loaded into the port
through the bridge; inputs come from numpy seeds.  Every dropout rate is
0 (JAX's and torch's random streams differ), the decoder prenet's
included.  float32 outputs are held within 1e-5 of their range.  The
port's attention projections are ``nn.Linear`` layers, so the flax
``DenseGeneral`` kernels come back from the bridge 2-D and are compared
in the flax shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.data.collate import transformer_tts_batch_fn as j_batch_fn
from parakeet_tpu.models.transformer_tts import TransformerTTS as JTTS
from parakeet_tpu.models.transformer_tts import \
    guided_multihead_attention_loss as j_guided
from parakeet_tpu.models.transformer_tts import transformer_tts_loss as j_loss
from parakeet_tpu.models.transformer_tts_updater import \
    make_transformer_tts_train_step as j_train_step
from parakeet_tpu.nn.style_encoder import StyleEncoder as JGST
from parakeet_tpu.nn.transformer import DecoderLayer as JDecoderLayer
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu.training.state import TrainState as JTrainState
from parakeet_tpu_torch.bridge import (RNG_KEY, _flax_leaves, flax_arrays,
                                       load_flax_params, load_train_state,
                                       train_state_arrays)
from parakeet_tpu_torch.data import transformer_tts_batch_fn
from parakeet_tpu_torch.models import (TransformerTTS,
                                       guided_multihead_attention_loss,
                                       init_transformer_tts_,
                                       init_transformer_tts_train_state,
                                       make_transformer_tts_eval_step,
                                       make_transformer_tts_train_step,
                                       transformer_tts_loss)
from parakeet_tpu_torch.nn.style_encoder import StyleEncoder
from parakeet_tpu_torch.nn.transformer import DecoderLayer, KVCache
from parakeet_tpu_torch.training import build_optimizer
from test_torch_speedyspeech import LR, _close, _randomize

torch.set_num_threads(1)

CFG = dict(idim=12, odim=8, embed_dim=8, eprenet_conv_layers=0,
           dprenet_layers=2, dprenet_units=8, elayers=2, eunits=16, adim=16,
           aheads=2, dlayers=2, dunits=16, postnet_layers=2, postnet_chans=8,
           postnet_filts=3)
# the encoder prenet's convolutions instead of the embedding input layer
PRENET = dict(eprenet_conv_layers=2, eprenet_conv_chans=8,
              eprenet_conv_filts=3)
GST = dict(use_gst=True, gst_tokens=3, gst_heads=2, gst_conv_layers=2,
           gst_conv_chans_list=(4, 6), gst_gru_units=6)
NO_DROPOUT = dict.fromkeys((
    "transformer_enc_dropout_rate", "transformer_enc_positional_dropout_rate",
    "transformer_enc_attn_dropout_rate", "transformer_dec_dropout_rate",
    "transformer_dec_positional_dropout_rate",
    "transformer_dec_attn_dropout_rate",
    "transformer_enc_dec_attn_dropout_rate", "eprenet_dropout_rate",
    "dprenet_dropout_rate", "postnet_dropout_rate"), 0.0)
T_TEXT, FRAMES = 9, 12
TEXT_LENGTHS = (9, 5)          # the second utterance is padded
FRAME_LENGTHS = (12, 8)


def _batch(seed):
    rng = np.random.default_rng(seed)
    text = np.zeros((2, T_TEXT), np.int64)
    for i, n in enumerate(TEXT_LENGTHS):
        text[i, :n] = rng.integers(1, 11, n)
    return {"text": text, "text_lengths": np.array(TEXT_LENGTHS),
            "speech": rng.standard_normal((2, FRAMES, 8)).astype(np.float32),
            "speech_lengths": np.array(FRAME_LENGTHS)}


def _jax_args(batch):
    return tuple(jnp.asarray(batch[k]) for k in (
        "text", "text_lengths", "speech", "speech_lengths"))


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flax_tree(module, seed, *args, **kw):
    """A numpy-randomized flat flax tree of ``module.init(*args)``."""
    shapes = jax.eval_shape(lambda k: module.init(
        {"params": k, "dropout": k}, *args, **kw), jax.random.PRNGKey(seed))
    return _randomize(flatten_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)), seed)


def _pair(seed=0, **kw):
    """(JAX model, port model with the same weights, the flat tree, the
    batch)."""
    batch = _batch(seed + 1)
    jm = JTTS(**{**CFG, **NO_DROPOUT, **kw})
    flat = _flax_tree(jm, seed, *_jax_args(batch), deterministic=False)
    tm = TransformerTTS(**{**CFG, **NO_DROPOUT, **kw})
    load_flax_params(tm, flat)          # raises on anything unmapped
    return jm, tm, flat, batch


def _in_flax_shapes(got, want):
    """``got`` (the bridge's arrays) reshaped to ``want``'s shapes."""
    return {k: np.asarray(v).reshape(np.shape(want[k])) for k, v in
            got.items() if k in want}


def test_decoder_layer_with_and_without_cache():
    """A decoder layer teacher-forced under a causal mask against JAX's
    (outputs and both attention stacks within 1e-5), then one step at a
    time through a ``KVCache`` (attending over the rows written so far):
    each step's row equals the teacher-forced row within 1e-5, as JAX's
    fixed, masked cache steps do."""
    rng = np.random.default_rng(3)
    b, t, t_enc, d = 2, 6, 7, 16
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    mem = rng.standard_normal((b, t_enc, d)).astype(np.float32)
    cross = np.arange(t_enc)[None, :] < np.array([[7], [4]])
    causal = np.tril(np.ones((t, t), bool))[None, None]
    cross_m = cross[:, None, None, :]
    jl = JDecoderLayer(d, 2, 24)
    args = [jnp.asarray(a) for a in (x, mem, causal, cross_m)]
    flat = _flax_tree(jl, 4, *args)
    v = nest_flat(flat)
    want, (want_sa, want_ca), _ = jl.apply(v, *args)
    tl = DecoderLayer(d, 2, 24)
    load_flax_params(tl, flat)
    tx, tmem = torch.from_numpy(x), torch.from_numpy(mem)
    got, (sa, ca) = tl(tx, tmem, torch.from_numpy(causal),
                       torch.from_numpy(cross_m))
    _close(got.detach(), want, what="x")
    _close(sa.detach(), want_sa, what="self weights")
    _close(ca.detach(), want_ca, what="cross weights")
    # JAX's fixed cache, one step at a time
    cache = {"k": jnp.zeros((b, t, 2, 8)), "v": jnp.zeros((b, t, 2, 8)),
             "index": jnp.zeros((), jnp.int32)}
    for i in range(t):
        row, _, cache = jl.apply(
            v, args[0][:, i:i + 1], args[1],
            (jnp.arange(t) <= i)[None, None, None, :], args[3], cache=cache)
        _close(np.asarray(row[:, 0]), want[:, i], what=f"jax step {i}")
    with torch.no_grad():
        kv = KVCache(b, t, 2, 8, torch.float32, "cpu")
        cross_kv = tl.cross_kv(tmem)
        for i in range(t):
            row, _ = tl(tx[:, i:i + 1], tmem, None,
                        torch.from_numpy(cross_m), cache=kv, cache_index=i,
                        cross_kv=cross_kv)
            _close(row[:, 0], want[:, i], what=f"step {i}")


@pytest.mark.parametrize("r,kw,deterministic", [
    (1, {}, True), (1, {}, False), (2, PRENET, False), (1, GST, True)])
def test_teacher_forced_matches_jax(r, kw, deterministic):
    """``forward`` on padded text and speech (the embedding input layer,
    or the encoder prenet with BatchNorm; GST reading the speech): every
    output and the three attention stacks within 1e-5 of their range; the
    BatchNorm running statistics a training forward updates as well."""
    jm, tm, _, batch = _pair(reduction_factor=r, **kw)
    variables = nest_flat(_flax_from(tm))
    want, mutated = jax.jit(lambda v: jm.apply(
        v, *_jax_args(batch), deterministic=deterministic,
        mutable=["batch_stats"]))(variables)
    tb = _tb(batch)
    got = tm(tb["text"], tb["text_lengths"], tb["speech"],
             tb["speech_lengths"], deterministic=deterministic)
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key].detach(), want[key], what=key)
    assert got["dec_cross_attns"].shape == (2, 2, 2, FRAMES // r, T_TEXT + 1)
    stats = flatten_tree({"batch_stats": mutated["batch_stats"]})
    mine = flax_arrays(tm)
    for key, value in stats.items():
        _close(mine[key], value, what=key)


def _flax_from(tm):
    """A copy of the port's parameters as a flax tree the JAX module takes
    (``flax_arrays`` may share the parameters' memory, which a training
    forward updates in place while JAX may still read it)."""
    out = {}
    for key, value in flax_arrays(tm).items():
        shape = _JAX_SHAPES.get(key, value.shape)
        out[key] = np.array(value).reshape(
            shape if np.prod(shape) == value.size else value.shape)
    return out


# every leaf's flax shape at CFG (adim 16, 2 heads; the DenseGeneral
# kernels and biases are 3-D and 2-D there), filled in by the first test
_JAX_SHAPES = {}


@pytest.fixture(autouse=True)
def _dense_general_shapes():
    if not _JAX_SHAPES:
        for kw in ({}, PRENET, GST):
            jm = JTTS(**{**CFG, **kw})
            _JAX_SHAPES.update({k: v.shape for k, v in _flax_tree(
                jm, 0, *_jax_args(_batch(0)),
                deterministic=False).items()})


def _stop_logits(tm, batch, steps, **kw):
    """The port's per-step max stop logit (B, steps) of ``inference``
    (every step's, min_decoder_steps 1), by a hook."""
    logits = []
    hook = tm.prob_out.register_forward_hook(
        lambda mod, args, out: logits.append(out.max(-1).values.detach()))
    tb = _tb(batch)
    with torch.no_grad():
        tm.inference(tb["text"], tb["text_lengths"], max_decoder_steps=steps,
                     min_decoder_steps=1, **kw)
    hook.remove()
    return torch.stack(logits, 1).numpy()


@pytest.mark.parametrize("r,seed", [(1, 8), (2, 10)])
def test_inference_matches_jax_across_a_stop(r, seed):
    """``inference`` over a fixed 14 steps (min_decoder_steps 3).  The
    stop projection's biases are shifted so that the first utterance's
    largest stop logit (rising over the steps at these seeds) first
    crosses 0 at step 7, by a margin above 1e-4
    on both sides: it stops inside the window, and the Postnet reads the
    frames made after the stop.  Lengths equal, mels (zero past each
    length) and the cross-attention weights within 1e-5 of their range; a
    decode cut at the stop changes
    the last valid frame (the frames after it fed the Postnet)."""
    steps, cross, min_steps = 14, 7, 3
    jm, tm, flat, batch = _pair(seed=seed, reduction_factor=r)
    logits = _stop_logits(tm, batch, steps)[0]
    shift = -(logits[cross - 1] + logits[cross]) / 2
    assert logits[min_steps - 1:cross].max() + shift < -1e-4
    assert logits[cross] + shift > 1e-4
    flat = dict(flat)
    flat["params::prob_out::bias"] = (flat["params::prob_out::bias"]
                                      + shift).astype(np.float32)
    load_flax_params(tm, flat)
    want = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(batch["text"]), jnp.asarray(batch["text_lengths"]),
        max_decoder_steps=steps, min_decoder_steps=min_steps,
        rngs={"dropout": jax.random.PRNGKey(0)},
        method=JTTS.inference))(nest_flat(flat))
    tb = _tb(batch)
    with torch.no_grad():
        got = tm.inference(tb["text"], tb["text_lengths"],
                           max_decoder_steps=steps,
                           min_decoder_steps=min_steps)
        n = (cross + 1) * r
        short = tm.inference(tb["text"], tb["text_lengths"],
                             max_decoder_steps=cross + 1,
                             min_decoder_steps=min_steps)
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))
    _close(got["mel"], want["mel"], what="mel")
    _close(got["cross_attns"], want["cross_attns"], what="attn")
    assert int(got["lengths"][0]) == n
    assert (got["mel"][0, n:] == 0).all()
    assert not torch.equal(short["mel"][0, n - 1], got["mel"][0, n - 1])


@pytest.mark.parametrize("loss_type", ["L1", "L2", "L1+L2"])
def test_losses_match_jax(loss_type):
    """``transformer_tts_loss`` (pos_weight 3) and
    ``guided_multihead_attention_loss`` over the last layer and first
    head, and over all of them: every term within 1e-6 relative."""
    rng = np.random.default_rng(8)
    batch = _batch(9)
    outputs = {"before_outs": rng.standard_normal((2, FRAMES, 8)),
               "after_outs": rng.standard_normal((2, FRAMES, 8)),
               "stop_logits": rng.standard_normal((2, FRAMES)) * 3}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    want = j_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                  *_jax_args(batch)[2:], loss_type=loss_type,
                  bce_pos_weight=3.0)
    tb = _tb(batch)
    got = transformer_tts_loss(_tb(outputs), tb["speech"],
                               tb["speech_lengths"], loss_type=loss_type,
                               bce_pos_weight=3.0)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    attns = rng.dirichlet(np.ones(T_TEXT + 1), (3, 2, 2, FRAMES)).astype(
        np.float32)
    dec, enc = np.array(FRAME_LENGTHS), np.array(TEXT_LENGTHS) + 1
    for kw in ({"num_layers": 1, "num_heads": 1}, {}):
        w = j_guided(jnp.asarray(attns), jnp.asarray(dec), jnp.asarray(enc),
                     sigma=0.3, **kw)
        g = guided_multihead_attention_loss(
            torch.from_numpy(attns), torch.from_numpy(dec),
            torch.from_numpy(enc), sigma=0.3, **kw)
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, GST])
def test_train_step_matches_jax_and_the_state_crosses(kw):
    """One Adam step (lr 1e-3) of the port's updater against the JAX
    updater's from the same weights and batch, with the recipe's
    ``updater`` keys (guided attention on 1 layer and 1 head, lambda 10):
    every loss within 1e-5 relative, each gradient within 1e-4 relative
    L2 of ``jax.grad``'s or within 1e-7 of the largest leaf's gradient
    (float32 rounding: a self-attention key bias has a true gradient of 0,
    since a softmax ignores a shift of its row), the parameters after the step within 1e-5 of
    each leaf's range (an element whose gradient is rounding noise may
    move by lr).  The train state crosses under the JAX TrainState's
    keys: the port's Adam moments against JAX's within 1e-4 of each
    leaf's range (GST's GRU gate by gate), and JAX's state loaded into a
    fresh port state comes back bitwise."""
    updater = dict(loss_type="L1", use_guided_attn_loss=True,
                   guided_attn_lambda=10.0, num_layers_applied_guided_attn=1,
                   num_heads_applied_guided_attn=1)
    jm, tm, flat, batch = _pair(seed=10, **kw)
    variables = nest_flat(_flax_from(tm))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jbuild("adam", LR)
    state = JTrainState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        opt_state=tx.init(variables["params"]),
                        batch_stats=variables.get("batch_stats"),
                        rng=jax.random.PRNGKey(0))
    step = j_train_step(jm, tx, jit=False, **updater)
    new_state, want = jax.jit(lambda st: step(st, jbatch))(state)
    grads = jax.jit(jax.grad(lambda p: _jax_full_loss(
        jm, variables, p, jbatch, updater)))(state.params)
    opt = build_optimizer(tm.parameters(), "adam", LR)
    tstate = init_transformer_tts_train_state(
        tm, opt, torch.Generator().manual_seed(0))
    tstate, got = make_transformer_tts_train_step(tm, opt, **updater)(
        tstate, _tb(batch))
    assert tstate.step == 1 and got["batch_size"].item() == 2.0
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    jax_g = flatten_tree({"params": grads})
    mine_g = _in_flax_shapes({key: conv(t.grad.numpy()) for key, _, t, conv
                              in _flax_leaves(tm)
                              if key.startswith("params::")}, jax_g)
    after = flatten_tree({"params": new_state.params})
    mine = _in_flax_shapes(flax_arrays(tm), after)
    assert mine_g.keys() == jax_g.keys()
    before = _in_flax_shapes(flat, after)
    scale = max(np.linalg.norm(np.asarray(g, np.float64))
                for g in jax_g.values())
    for key, g in jax_g.items():
        g = np.asarray(g, np.float64)
        err = np.linalg.norm(mine_g[key] - g)
        assert err <= max(1e-4 * np.linalg.norm(g), 1e-7 * scale), (key, err)
        # Adam moves an element by lr times the sign of its gradient: where
        # that is rounding noise (a whole leaf below 1e-5 of the largest,
        # or an element below 1e-3 of its leaf's largest), only the size
        # of the move is held
        sure = ((np.abs(g) >= 1e-3 * np.abs(g).max())
                & (np.linalg.norm(g) >= 1e-5 * scale))
        if sure.any():
            _close(mine[key][sure], np.asarray(after[key])[sure], what=key)
        assert (np.abs(mine[key] - before[key])[~sure] <= LR * 1.001).all()
    want_flat = flatten_tree(new_state)
    got_flat = train_state_arrays(tstate)
    assert set(got_flat) - {RNG_KEY} == set(want_flat) - {"rng"}
    for key, value in want_flat.items():
        if key.startswith("opt_state::"):
            _close(np.asarray(got_flat[key]).reshape(np.shape(value)), value,
                   rel=1e-4, what=key)
    if kw:
        assert "opt_state::0::mu::gst::ref_enc::GRUCell_0::hn::bias" in \
            got_flat
    fresh = TransformerTTS(**{**CFG, **NO_DROPOUT, **kw})
    fresh_state = init_transformer_tts_train_state(
        fresh, build_optimizer(fresh.parameters(), "adam", LR),
        torch.Generator().manual_seed(0))
    load_train_state(fresh_state, {k: np.asarray(v)
                                   for k, v in want_flat.items()})
    back = train_state_arrays(fresh_state)
    for key, value in want_flat.items():
        if key != "rng":
            np.testing.assert_array_equal(
                np.asarray(back[key]).reshape(np.shape(value)),
                np.asarray(value), err_msg=key)


def _jax_full_loss(jm, variables, params, jbatch, updater):
    """The JAX updater's loss (``transformer_tts_loss`` + lambda x guided)
    of a training forward, for ``jax.grad``."""
    v = {"params": params}
    if "batch_stats" in variables:
        v["batch_stats"] = variables["batch_stats"]
    out, _ = jm.apply(v, jbatch["text"], jbatch["text_lengths"],
                      jbatch["speech"], jbatch["speech_lengths"],
                      deterministic=False,
                      rngs={"dropout": jax.random.PRNGKey(1)},
                      mutable=["batch_stats"])
    loss = j_loss(out, jbatch["speech"], jbatch["speech_lengths"],
                  loss_type=updater["loss_type"])["loss"]
    ga = j_guided(out["dec_cross_attns"], jbatch["speech_lengths"],
                  jbatch["text_lengths"] + 1, sigma=0.4, num_layers=1,
                  num_heads=1)
    return loss + updater["guided_attn_lambda"] * ga


@pytest.mark.parametrize("frames", [20, 31])
def test_gst_matches_jax_and_round_trips(frames):
    """GST (2-D convolutions with flax's SAME padding at stride 2, even
    and odd lengths; BatchNorm on running statistics; the GRU; the token
    attention) against JAX's within 1e-5 of the range; every leaf of its
    flax tree (Conv2d kernels, BatchNorm statistics, the GRU's gates with
    the hidden-side bias on n only, the bias-free DenseGeneral q/k/v, the
    token table) comes back from the port bitwise."""
    rng = np.random.default_rng(frames)
    speech = rng.standard_normal((2, frames, 8)).astype(np.float32)
    jg = JGST(gst_tokens=3, gst_token_dim=16, gst_heads=2, conv_layers=3,
              conv_chans_list=(4, 6, 6), gru_units=6)
    flat = _flax_tree(jg, 5, jnp.asarray(speech))
    want = jg.apply(nest_flat(flat), jnp.asarray(speech))
    tg = StyleEncoder(8, 3, 16, 2, 3, (4, 6, 6), gru_units=6)
    load_flax_params(tg, flat)
    assert "bias_hh" not in dict(tg.named_parameters())
    _close(tg(torch.from_numpy(speech)).detach(), want, what="style")
    back = _in_flax_shapes(flax_arrays(tg), flat)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)


def test_eval_step_repeats_and_init_draws_flax_defaults():
    """The eval step (decoder prenet masks from a fixed seed) repeats
    itself with the prenet dropping; ``init_transformer_tts_`` draws
    GST's tokens N(0, 0.5^2) and leaves the positional alphas at 1."""
    model = TransformerTTS(**CFG, **GST)
    init_transformer_tts_(model, torch.Generator().manual_seed(0))
    tokens = model.gst.stl.gst_tokens_param
    assert 0.2 < tokens.std().item() < 1.0
    assert model.encoder.pos_enc.alpha.item() == 1.0
    step = make_transformer_tts_eval_step(model)
    tb = _tb(_batch(3))
    first, second = step(None, tb), step(None, tb)
    assert first.keys() == {"l1_loss", "bce_loss", "guided_attn_loss",
                            "loss"}
    for k in first:
        assert torch.isfinite(first[k]) and torch.equal(first[k], second[k])


def test_batch_fn_matches_jax():
    """``transformer_tts_batch_fn`` against JAX's, bitwise (buckets of 16
    tokens and 64 frames)."""
    rng = np.random.default_rng(12)
    examples = [{"text": rng.integers(1, 30, n),
                 "speech": rng.standard_normal((f, 8)).astype(np.float32)}
                for n, f in ((5, 70), (17, 20), (9, 64))]
    want = j_batch_fn(examples)
    got = transformer_tts_batch_fn(examples)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
