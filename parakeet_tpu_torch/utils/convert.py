"""Convert released Paddle Parakeet checkpoints to the port's flat
checkpoint tree (counterpart of ``parakeet_tpu/utils/convert.py``, a copy
of its numpy code: the port imports nothing of the JAX package).

The reference ships weight-normalized Paddle state dicts (reference:
parakeet/models/parallel_wavegan/parallel_wavegan.py:401-496; released
checkpoints listed in README.md:90-120).  Each converter returns the
nested flax-layout tree the port's modules carry (``bridge.py`` loads
it), and ``checkpoint_arrays`` flattens it into the ``params::...`` /
``batch_stats::...`` keys ``training/checkpoint.py::save_pytree`` writes,
so a converted file is a checkpoint every ``--checkpoint`` flag of the
port takes.  Layout differences handled here:

- Paddle Conv1D weight (out, in, k)  ->  flax kernel (k, in, out)
- Paddle Conv2D weight (out=1, in=1, kf, kt) -> UpsampleNet kernel
  (kt, kf, 1, 1)  (the reference's mel "image" is (B, 1, F, T'): freq is
  H, time is W, parallel_wavegan.py:101-133)
- paddle weight_norm (weight_g, weight_v) -> our (scale, kernel): both
  parameterize weight = g * v / ||v|| with the norm over every axis but
  the output channel, so scale = g.flatten(), kernel = transposed v
- per-block ResidualBlock weights (conv_layers.{i}.*) -> layer-stacked
  (L, ...) arrays of ResidualStack

Input format: a dict of numpy arrays keyed by Paddle parameter names
(e.g. ``np.load("ckpt.npz")`` of a paddle-side
``np.savez(path, **{k: np.asarray(v) for k, v in sd.items()})`` dump, or
a pickle of the same).  Loading ``.pdparams`` directly requires paddle
to unpickle; dump to npz on the paddle side first.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..training.checkpoint import flatten_nested

__all__ = ["load_paddle_state", "checkpoint_arrays",
           "convert_pwg_generator",
           "convert_pwg_discriminator",
           "convert_fastspeech2", "convert_waveflow", "convert_ge2e",
           "convert_speedyspeech", "convert_tacotron2",
           "convert_transformer_tts"]


def load_paddle_state(path) -> Dict[str, np.ndarray]:
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    import pickle
    with open(path, "rb") as f:
        state = pickle.load(f)
    return {k: np.asarray(v) for k, v in state.items()}


def checkpoint_arrays(params: Dict[str, dict],
                      batch_stats: Optional[Dict[str, dict]] = None
                      ) -> Dict[str, np.ndarray]:
    """A converter's trees as the flat ``params::a::b`` (and
    ``batch_stats::...``) keys of a checkpoint file, the keys the JAX
    package's ``flatten_tree`` gives the same trees."""
    tree = {"params": params}
    if batch_stats is not None:
        tree["batch_stats"] = batch_stats
    return flatten_nested(tree)


def _wn_conv1d(state, prefix, bias=True):
    """paddle weight-normed Conv1D -> {kernel, scale[, bias]}."""
    v = state[f"{prefix}.weight_v"]
    g = state[f"{prefix}.weight_g"]
    out = {"kernel": v.transpose(2, 1, 0).astype(np.float32),
           "scale": g.reshape(-1).astype(np.float32)}
    if bias:
        out["bias"] = state[f"{prefix}.bias"].astype(np.float32)
    return out


def convert_pwg_discriminator(state: Dict[str, np.ndarray],
                              layers: int = 10) -> Dict[str, dict]:
    """Paddle PWGDiscriminator state dict -> port params tree
    (drop-in for ``PWGDiscriminator(...).init(...)['params']``).

    The paddle module is one nn.Sequential of [conv, act] pairs plus a
    final conv (reference: parallel_wavegan.py:554-598), so the convs
    sit at even indices 0, 2, ..., 2*(layers-1).  Needed to resume GAN
    *training* from a released checkpoint (synthesis only loads the
    generator).
    """
    params: Dict[str, dict] = {}
    for i in range(layers - 1):
        params[f"conv_{i}"] = _wn_conv1d(state, f"conv_layers.{2 * i}")
    params["conv_last"] = _wn_conv1d(
        state, f"conv_layers.{2 * (layers - 1)}")
    return params


def convert_pwg_generator(state: Dict[str, np.ndarray],
                          layers: int = 30,
                          upsample_scales=(4, 5, 3, 5),
                          nonlinear_activation: bool = False
                          ) -> Dict[str, dict]:
    """Paddle PWGGenerator state dict -> port params tree
    (drop-in for ``PWGGenerator(...).init(...)['params']``)."""
    params: Dict[str, dict] = {}
    params["first_conv"] = _wn_conv1d(state, "first_conv")

    up: Dict[str, np.ndarray] = {}
    up_net = {"conv_in": _wn_conv1d(state, "upsample_net.conv_in",
                                    bias=False)}
    # up_layers = [Stretch2D, Conv2D(, activation)] per scale; convs sit
    # at index 1 within each group (parallel_wavegan.py:101-117)
    group = 3 if nonlinear_activation else 2
    for i, _scale in enumerate(upsample_scales):
        idx = i * group + 1
        v = state[f"upsample_net.upsample.up_layers.{idx}.weight_v"]
        g = state[f"upsample_net.upsample.up_layers.{idx}.weight_g"]
        # (1, 1, kf, kt) -> (kt, kf, 1, 1)
        up[f"conv_{i}_kernel"] = v[0, 0].T[..., None, None].astype(
            np.float32)
        up[f"conv_{i}_scale"] = g.reshape(-1).astype(np.float32)
    up_net["upsample"] = up
    params["upsample_net"] = up_net

    stack: Dict[str, np.ndarray] = {}

    def stack_conv(name, paddle_attr, bias):
        ks, gs, bs = [], [], []
        for i in range(layers):
            p = f"conv_layers.{i}.{paddle_attr}"
            ks.append(state[f"{p}.weight_v"].transpose(2, 1, 0))
            gs.append(state[f"{p}.weight_g"].reshape(-1))
            if bias:
                bs.append(state[f"{p}.bias"])
        stack[f"{name}_kernel"] = np.stack(ks).astype(np.float32)
        stack[f"{name}_scale"] = np.stack(gs).astype(np.float32)
        if bias:
            stack[f"{name}_bias"] = np.stack(bs).astype(np.float32)

    stack_conv("conv", "conv", bias=True)
    stack_conv("aux", "conv1x1_aux", bias=False)
    stack_conv("skip", "conv1x1_skip", bias=True)
    stack_conv("out", "conv1x1_out", bias=True)
    # stacked dilated kernels: (L, k, in, out); 1x1 convs collapse to
    # (L, in, out)
    stack["aux_kernel"] = stack["aux_kernel"][:, 0]
    stack["skip_kernel"] = stack["skip_kernel"][:, 0]
    stack["out_kernel"] = stack["out_kernel"][:, 0]
    params["stack"] = stack

    # last_conv_layers = Sequential(ReLU, Conv1D, ReLU, Conv1D)
    params["last_conv_0"] = _wn_conv1d(state, "last_conv_layers.1")
    params["last_conv_1"] = _wn_conv1d(state, "last_conv_layers.3")
    return params


def _wn_fold(v, g):
    """weight = g * v / ||v|| with the norm over every axis but 0
    (paddle nn.utils.weight_norm default dim=0)."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True) + 1e-12)
    return v * (g.reshape((-1,) + (1,) * (v.ndim - 1)) / norm)


def _wn_weight(state, prefix):
    """Weight of a (possibly) weight-normed paddle conv: read the plain
    ``.weight`` when present (a ``remove_weight_norm``-ed dump, or a
    gradient dict w.r.t. the folded weight), else fold (v, g)."""
    if f"{prefix}.weight" in state:
        return np.asarray(state[f"{prefix}.weight"])
    return _wn_fold(state[f"{prefix}.weight_v"], state[f"{prefix}.weight_g"])


def _wn_conv2d(state, prefix, bias=True):
    """paddle weight-normed Conv2D (O, I, kh, kw) -> folded flax
    {kernel (kh, kw, I, O)[, bias]} (weight norm is an inference no-op
    once folded; we train plain convs)."""
    w = _wn_weight(state, prefix)
    out = {"kernel": w.transpose(2, 3, 1, 0).astype(np.float32)}
    if bias:
        out["bias"] = state[f"{prefix}.bias"].astype(np.float32)
    return out


def convert_waveflow(state: Dict[str, np.ndarray],
                     n_flows: int = 8, n_layers: int = 8,
                     upsample_factors=(16, 16)) -> Dict[str, dict]:
    """Paddle ConditionalWaveFlow state dict -> port params
    tree (drop-in for ``ConditionalWaveFlow(...).init(...)['params']``).

    Reference module tree: encoder = UpsampleNet (weight-normed
    Conv2DTranspose per factor, waveflow.py:84-102), decoder = WaveFlow
    of ``n_flows`` Flows (waveflow.py:584-601), each Flow = weight-normed
    input_proj + ResidualNet(conv/condition_proj/out_proj per layer) +
    plain zero-init output_proj (waveflow.py:428-451).

    Layout notes:
    - paddle Conv2DTranspose computes a conv of the stride-dilated input
      with the *spatially flipped* kernel; our UpsampleNet (and
      flax.linen.ConvTranspose, against which it is verified) uses the
      kernel as-is, so both spatial axes are flipped here.  paddle's
      padding (1, factor // 2) equals SAME for even factors — the only
      ones the reference allows (n_group must be even).
    - height dilations (n_group >= 32, waveflow.py:420-426) do not
      change parameter shapes; the model derives them from n_group.
    - accepts both weight-normed dumps (``.weight_v``/``.weight_g``) and
      pre-folded ones (plain ``.weight``, e.g. after the reference's
      ``remove_weight_norm``); with plain weights every transform is a
      pure reindexing, so the converter also maps gradient dicts
      (tools/golden/run_parity.py uses this for WaveFlow grad parity).
    """
    for f in upsample_factors:
        if f % 2:
            raise ValueError(
                f"odd upsample factor {f}: paddle padding (1, f//2) only "
                "matches our SAME-padding upsampler for even factors")
    params: Dict[str, dict] = {}

    encoder: Dict[str, np.ndarray] = {}
    for i, _f in enumerate(upsample_factors):
        w = _wn_weight(state, f"encoder.{i}")
        # (in=1, out=1, 3, 2f), flip both spatial axes -> (3, 2f, 1, 1)
        encoder[f"deconv_{i}_kernel"] = (
            w[0, 0, ::-1, ::-1][..., None, None].astype(np.float32))
        encoder[f"deconv_{i}_bias"] = state[f"encoder.{i}.bias"].astype(
            np.float32)
    params["encoder"] = encoder

    decoder: Dict[str, dict] = {}
    for f in range(n_flows):
        fp = f"decoder.{f}"
        flow = {"input_proj": _wn_conv2d(state, f"{fp}.input_proj"),
                "output_proj": {
                    "kernel": state[f"{fp}.output_proj.weight"].transpose(
                        2, 3, 1, 0).astype(np.float32),
                    "bias": state[f"{fp}.output_proj.bias"].astype(
                        np.float32)}}
        for layer in range(n_layers):
            lp = f"{fp}.resnet.{layer}"
            flow[f"resnet_{layer}"] = {
                "conv": _wn_conv2d(state, f"{lp}.conv"),
                "condition_proj": _wn_conv2d(state, f"{lp}.condition_proj"),
                "out_proj": _wn_conv2d(state, f"{lp}.out_proj"),
            }
        decoder[f"flows_{f}"] = flow
    params["decoder"] = decoder
    return params


def convert_ge2e(state: Dict[str, np.ndarray],
                 num_layers: int = 3) -> Dict[str, dict]:
    """Paddle LSTMSpeakerEncoder state dict -> port params tree
    (drop-in for ``LSTMSpeakerEncoder(...).init(...)['params']``).

    Reference module tree (lstm_speaker_encoder.py:24-33): nn.LSTM
    (weight_ih_l{k} (4H, in), weight_hh_l{k} (4H, H), bias_ih/bias_hh
    (4H,), gate order i,f,c,o) + Linear + similarity_weight/bias.

    Our flax LSTMCell keeps per-gate dense layers (ii/if/ig/io without
    bias, hi/hf/hg/ho with bias); paddle's c-gate is flax's g-gate, and
    the two paddle bias vectors fold into the single flax h-side bias.
    """
    params: Dict[str, dict] = {}
    for layer in range(num_layers):
        params[f"lstm_{layer}"] = {
            "cell": _lstm_cell(state, "lstm", f"_l{layer}")}
    params["linear"] = _dense(state, "linear")
    params["similarity_weight"] = state["similarity_weight"].reshape(
        ()).astype(np.float32)
    params["similarity_bias"] = state["similarity_bias"].reshape(
        ()).astype(np.float32)
    return params


def _conv1d(state, prefix, bias=True):
    """paddle Conv1D (out, in, k) -> flax kernel (k, in, out)."""
    out = {"kernel": state[f"{prefix}.weight"].transpose(2, 1, 0).astype(
        np.float32)}
    if bias:
        out["bias"] = state[f"{prefix}.bias"].astype(np.float32)
    return out


def _dense(state, prefix):
    """paddle Linear (in, out) -> flax kernel (in, out): direct copy."""
    return {"kernel": state[f"{prefix}.weight"].astype(np.float32),
            "bias": state[f"{prefix}.bias"].astype(np.float32)}


def _layernorm(state, prefix):
    return {"scale": state[f"{prefix}.weight"].astype(np.float32),
            "bias": state[f"{prefix}.bias"].astype(np.float32)}


def _mha(state, prefix, heads):
    """ESPnet MultiHeadedAttention linear_{q,k,v,out} -> flax q/k/v/out.

    paddle Linear weight is (in, out); q/k/v reshape the OUT dim into
    (heads, head_dim), the out-projection reshapes the IN dim — matching
    the contiguous head split of the reference (fastspeech2_transformer/
    attention.py:42-90).
    """
    feat = state[f"{prefix}.linear_q.weight"].shape[0]
    dk = feat // heads
    out = {}
    for name in ("q", "k", "v"):
        w = state[f"{prefix}.linear_{name}.weight"].astype(np.float32)
        b = state[f"{prefix}.linear_{name}.bias"].astype(np.float32)
        out[name] = {"kernel": w.reshape(feat, heads, dk),
                     "bias": b.reshape(heads, dk)}
    w = state[f"{prefix}.linear_out.weight"].astype(np.float32)
    out["out"] = {"kernel": w.reshape(heads, dk, feat),
                  "bias": state[f"{prefix}.linear_out.bias"].astype(
                      np.float32)}
    return out


def _transformer_stack(state, prefix, n_layers, heads, pos_alpha_idx):
    """ESPnet TransformerEncoder -> our encoder/decoder subtree.

    ``pos_alpha_idx``: index of ScaledPositionalEncoding inside the
    paddle ``embed`` Sequential (1 when preceded by an Embedding, 0 for
    the decoder's input_layer=None case, fastspeech2.py:171-269).
    """
    tree = {"pos_enc": {"alpha": state[
        f"{prefix}.embed.{pos_alpha_idx}.alpha"].reshape(1).astype(
            np.float32)}}
    if pos_alpha_idx == 1:
        tree["embed"] = {"embedding": state[
            f"{prefix}.embed.0.weight"].astype(np.float32)}
    for i in range(n_layers):
        lp = f"{prefix}.encoders.{i}"
        tree[f"layer_{i}"] = {
            "self_attn": _mha(state, f"{lp}.self_attn", heads),
            "norm1": _layernorm(state, f"{lp}.norm1"),
            "norm2": _layernorm(state, f"{lp}.norm2"),
            "MultiLayerConv_0": {
                "Conv_0": _conv1d(state, f"{lp}.feed_forward.w_1"),
                "Conv_1": _conv1d(state, f"{lp}.feed_forward.w_2"),
            },
        }
    tree["after_norm"] = _layernorm(state, f"{prefix}.after_norm")
    return tree


def _espnet_postnet(state, prefix, n_layers):
    """ESPnet Postnet (bias-free convs + BatchNorm1D) -> (params,
    batch_stats) subtrees (reference tacotron2/decoder.py:84-160)."""
    params, stats = {}, {}
    for i in range(n_layers):
        params[f"conv_{i}"] = _conv1d(state, f"{prefix}.{i}.0", bias=False)
        bn = f"{prefix}.{i}.1"
        params[f"bn_{i}"] = _layernorm(state, bn)
        stats[f"bn_{i}"] = {
            "mean": state[f"{bn}._mean"].astype(np.float32),
            "var": state[f"{bn}._variance"].astype(np.float32)}
    return params, stats


def convert_transformer_tts(state: Dict[str, np.ndarray],
                            elayers: int = 6, dlayers: int = 6,
                            aheads: int = 8, dprenet_layers: int = 2,
                            postnet_layers: int = 5,
                            reduction_factor: int = 1):
    """Paddle TransformerTTS state dict -> (params, batch_stats) pytrees
    (drop-in for ``TransformerTTS(...).init(...)``); reference module
    tree at parakeet/models/transformer_tts/transformer_tts.py:172-386.

    Covers the released ljspeech-0.4 configuration: plain-Embedding
    encoder input (eprenet_conv_layers=0), scaled positional encodings,
    decoder prenet + projection, no GST / speaker embedding.
    """
    del reduction_factor
    params = {
        "encoder": _transformer_stack(state, "encoder", elayers, aheads,
                                      pos_alpha_idx=1),
    }

    dec = {"pos_enc": {"alpha": state["decoder.embed.1.alpha"].reshape(
        1).astype(np.float32)}}
    for i in range(dlayers):
        lp = f"decoder.decoders.{i}"
        dec[f"layer_{i}"] = {
            "self_attn": _mha(state, f"{lp}.self_attn", aheads),
            "src_attn": _mha(state, f"{lp}.src_attn", aheads),
            "norm1": _layernorm(state, f"{lp}.norm1"),
            "norm2": _layernorm(state, f"{lp}.norm2"),
            "norm3": _layernorm(state, f"{lp}.norm3"),
            # decoder FF is linear PositionwiseFeedForward
            # (fastspeech2_transformer/decoder.py:145-151)
            "ff": {"Dense_0": _dense(state, f"{lp}.feed_forward.w_1"),
                   "Dense_1": _dense(state, f"{lp}.feed_forward.w_2")},
        }
    dec["after_norm"] = _layernorm(state, "decoder.after_norm")
    params["decoder"] = dec

    # decoder.embed.0 = Sequential(DecoderPrenet, Linear) — prenet.{j} =
    # Sequential(Linear, ReLU) (tacotron2/decoder.py:57-63)
    prenet = {}
    for j in range(dprenet_layers):
        prenet[f"fc_{j}"] = _dense(state, f"decoder.embed.0.0.prenet.{j}.0")
    params["decoder_prenet"] = prenet
    params["decoder_prenet_proj"] = _dense(state, "decoder.embed.0.1")

    params["feat_out"] = _dense(state, "feat_out")
    params["prob_out"] = _dense(state, "prob_out")

    post_params, post_stats = _espnet_postnet(state, "postnet.postnet",
                                              postnet_layers)
    params["postnet"] = post_params
    return params, {"postnet": post_stats}


def _predictor(state, prefix, n_layers):
    """Duration/variance predictor conv stack (duration_predictor.py:
    69-83: conv.{i} = Sequential(Conv1D, ReLU, LayerNorm, Dropout))."""
    stack = {}
    for i in range(n_layers):
        stack[f"conv_{i}"] = _conv1d(state, f"{prefix}.conv.{i}.0")
        stack[f"norm_{i}"] = _layernorm(state, f"{prefix}.conv.{i}.2")
    stack["linear"] = _dense(state, f"{prefix}.linear")
    return {"stack": stack}


def _batchnorm(state, prefix):
    """paddle BatchNorm1D -> (params {scale, bias}, stats {mean, var})."""
    return ({"scale": state[f"{prefix}.weight"].astype(np.float32),
             "bias": state[f"{prefix}.bias"].astype(np.float32)},
            {"mean": state[f"{prefix}._mean"].astype(np.float32),
             "var": state[f"{prefix}._variance"].astype(np.float32)})


def _ss_residual_block(state, prefix, n):
    """SpeedySpeech ResidualBlock (speedyspeech.py:20-38): blocks.{j} =
    Sequential(Conv1D @0, ReLU, BatchNorm1D @2) -> our conv_{j}/bn_{j}."""
    params, stats = {}, {}
    for j in range(n):
        params[f"conv_{j}"] = _conv1d(state, f"{prefix}.blocks.{j}.0")
        bn_p, bn_s = _batchnorm(state, f"{prefix}.blocks.{j}.2")
        params[f"bn_{j}"] = bn_p
        stats[f"bn_{j}"] = bn_s
    return params, stats


def convert_speedyspeech(state: Dict[str, np.ndarray],
                         encoder_dilations=(1, 3, 9, 27, 1, 3, 9, 27, 1, 1),
                         decoder_dilations=(1, 3, 9, 27, 1, 3, 9, 27, 1, 3,
                                            9, 27, 1, 3, 9, 27, 1, 1),
                         tone: bool = True):
    """Paddle SpeedySpeech state dict -> (params, batch_stats) pytrees
    (drop-in for ``SpeedySpeech(...).init(...)``); reference module tree
    at parakeet/models/speedyspeech/speedyspeech.py:20-165."""
    params: Dict[str, dict] = {}
    stats: Dict[str, dict] = {}

    emb = {"text_embed": {"embedding": state[
        "encoder.embedding.text_embedding.weight"].astype(np.float32)}}
    if tone:
        emb["tone_embed"] = {"embedding": state[
            "encoder.embedding.tone_embedding.weight"].astype(np.float32)}
    params["embedding"] = emb

    enc = {"prenet_fc": _dense(state, "encoder.prenet.0")}
    enc_stats = {}
    for i, _d in enumerate(encoder_dilations):
        p, s = _ss_residual_block(state, f"encoder.res_blocks.{i}", n=2)
        enc[f"res_{i}"] = p
        enc_stats[f"res_{i}"] = s
    enc["postnet1_fc"] = _dense(state, "encoder.postnet1.0")
    bn_p, bn_s = _batchnorm(state, "encoder.postnet2.1")
    enc["postnet2_bn"] = bn_p
    enc_stats["postnet2_bn"] = bn_s
    enc["postnet2_fc"] = _dense(state, "encoder.postnet2.2")
    params["encoder"] = enc
    stats["encoder"] = enc_stats

    dp = {}
    dp_stats = {}
    for i in range(3):  # kernel sizes 4 / 3 / 1, one sub-block each
        p, s = _ss_residual_block(state,
                                  f"duration_predictor.layers.{i}", n=1)
        dp[f"res_{i}"] = p
        dp_stats[f"res_{i}"] = s
    dp["fc"] = _dense(state, "duration_predictor.layers.3")
    params["duration_predictor"] = dp
    stats["duration_predictor"] = dp_stats

    dec = {}
    dec_stats = {}
    for i, _d in enumerate(decoder_dilations):
        p, s = _ss_residual_block(state, f"decoder.res_blocks.{i}", n=2)
        dec[f"res_{i}"] = p
        dec_stats[f"res_{i}"] = s
    dec["postnet1_fc"] = _dense(state, "decoder.postnet1.0")
    p, s = _ss_residual_block(state, "decoder.postnet2.0", n=2)
    dec["postnet2_res"] = p
    dec_stats["postnet2_res"] = s
    dec["fc"] = _dense(state, "decoder.postnet2.1")
    params["decoder"] = dec
    stats["decoder"] = dec_stats
    return params, stats


def _lstm_cell(state, prefix, suffix=""):
    """paddle LSTM/LSTMCell weights (weight_ih (4H, in), weight_hh,
    bias_ih + bias_hh; gate order i,f,c,o) -> flax per-gate dense tree
    (ii/if/ig/io bias-free, hi/hf/hg/ho with the folded bias)."""
    w_ih = state[f"{prefix}.weight_ih{suffix}"].astype(np.float32)
    w_hh = state[f"{prefix}.weight_hh{suffix}"].astype(np.float32)
    b = (state[f"{prefix}.bias_ih{suffix}"]
         + state[f"{prefix}.bias_hh{suffix}"]).astype(np.float32)
    h = w_hh.shape[1]
    cell = {}
    for gi, g in enumerate(("i", "f", "g", "o")):
        sl = slice(gi * h, (gi + 1) * h)
        cell[f"i{g}"] = {"kernel": w_ih[sl].T}
        cell[f"h{g}"] = {"kernel": w_hh[sl].T, "bias": b[sl]}
    return cell


def _conv_bn_fold(state, conv_prefix, bn_prefix):
    """Conv1dBatchNorm (conv WITH bias -> BN, reference
    parakeet/modules/conv.py:230-259) -> bias-free conv + BN whose
    running mean absorbs the conv bias (exact at inference; in training
    mode BN subtracts the batch mean so a conv bias is a no-op anyway)."""
    conv = {"kernel": state[f"{conv_prefix}.weight"].transpose(
        2, 1, 0).astype(np.float32)}
    bias = state.get(f"{conv_prefix}.bias")
    bn = {"scale": state[f"{bn_prefix}.weight"].astype(np.float32),
          "bias": state[f"{bn_prefix}.bias"].astype(np.float32)}
    mean = state[f"{bn_prefix}._mean"].astype(np.float32)
    if bias is not None:
        mean = mean - bias.astype(np.float32)
    stats = {"mean": mean,
             "var": state[f"{bn_prefix}._variance"].astype(np.float32)}
    return conv, bn, stats


def _dense_nobias(state, prefix):
    return {"kernel": state[f"{prefix}.weight"].astype(np.float32)}


def convert_tacotron2(state: Dict[str, np.ndarray],
                      encoder_conv_layers: int = 3,
                      postnet_conv_layers: int = 5,
                      use_stop_token: bool = False,
                      toned: bool = False):
    """Paddle Tacotron2 state dict -> (params, batch_stats) pytrees
    (drop-in for ``Tacotron2(...).init(...)``); reference module tree at
    parakeet/models/tacotron2.py:31-885.

    The released checkpoints store Conv1dBatchNorm convs with biases;
    those are folded into the BN running means (see _conv_bn_fold).
    """
    params: Dict[str, dict] = {}
    stats: Dict[str, dict] = {}

    params["embedding"] = {"embedding": state["embedding.weight"].astype(
        np.float32)}
    if toned:
        params["embedding_tones"] = {"embedding": state[
            "embedding_tones.weight"].astype(np.float32)}

    enc: Dict[str, dict] = {}
    enc_stats: Dict[str, dict] = {}
    for i in range(encoder_conv_layers):
        p = f"encoder.conv_batchnorms.{i}"
        conv, bn, st = _conv_bn_fold(state, f"{p}.conv", f"{p}.bn")
        enc[f"conv_{i}"] = conv
        enc[f"bn_{i}"] = bn
        enc_stats[f"bn_{i}"] = st
    # bidirectional LSTM: forward = cell 0, reverse = cell 1
    enc["OptimizedLSTMCell_0"] = _lstm_cell(state, "encoder.lstm", "_l0")
    enc["OptimizedLSTMCell_1"] = _lstm_cell(state, "encoder.lstm",
                                            "_l0_reverse")
    params["encoder"] = enc
    stats["encoder"] = enc_stats

    params["prenet"] = {
        "fc_0": _dense_nobias(state, "decoder.prenet.linear1"),
        "fc_1": _dense_nobias(state, "decoder.prenet.linear2")}

    att = {"query_layer": _dense_nobias(
               state, "decoder.attention_layer.query_layer"),
           "key_layer": _dense_nobias(
               state, "decoder.attention_layer.key_layer"),
           "value": _dense_nobias(state, "decoder.attention_layer.value"),
           "location_layer": _dense_nobias(
               state, "decoder.attention_layer.location_layer"),
           "location_conv": {"kernel": state[
               "decoder.attention_layer.location_conv.weight"].transpose(
                   2, 1, 0).astype(np.float32)}}
    cell = {"attention_rnn": _lstm_cell(state, "decoder.attention_rnn"),
            "decoder_rnn": _lstm_cell(state, "decoder.decoder_rnn"),
            "attention": att,
            "frame_proj": _dense(state, "decoder.linear_projection")}
    if use_stop_token:
        cell["stop_proj"] = _dense(state, "decoder.stop_layer")
    params["cell"] = cell

    post: Dict[str, dict] = {}
    post_stats: Dict[str, dict] = {}
    for i in range(postnet_conv_layers):
        p = f"postnet.conv_batchnorms.{i}"
        conv, bn, st = _conv_bn_fold(state, f"{p}.conv", f"{p}.bn")
        post[f"conv_{i}"] = conv
        post[f"bn_{i}"] = bn
        post_stats[f"bn_{i}"] = st
    params["postnet"] = post
    stats["postnet"] = post_stats
    return params, stats


def convert_fastspeech2(state: Dict[str, np.ndarray],
                        elayers: int = 4, dlayers: int = 4,
                        aheads: int = 2, postnet_layers: int = 5,
                        predictor_layers: int = 2,
                        pitch_predictor_layers: int = 5,
                        energy_predictor_layers: int = 2):
    """Paddle FastSpeech2 state dict -> (params, batch_stats) pytrees
    (drop-in for ``FastSpeech2(...).init(...)``); reference module tree
    at parakeet/models/fastspeech2/fastspeech2.py:171-274."""
    params = {
        "encoder": _transformer_stack(state, "encoder", elayers, aheads,
                                      pos_alpha_idx=1),
        "decoder": _transformer_stack(state, "decoder", dlayers, aheads,
                                      pos_alpha_idx=0),
        "duration_predictor": _predictor(state, "duration_predictor",
                                         predictor_layers),
        "pitch_predictor": _predictor(state, "pitch_predictor",
                                      pitch_predictor_layers),
        "energy_predictor": _predictor(state, "energy_predictor",
                                       energy_predictor_layers),
        "pitch_embed": {"conv": _conv1d(state, "pitch_embed.0")},
        "energy_embed": {"conv": _conv1d(state, "energy_embed.0")},
        "feat_out": _dense(state, "feat_out"),
    }
    batch_stats = {}
    postnet = {}
    bn_stats = {}
    for i in range(postnet_layers):
        postnet[f"conv_{i}"] = _conv1d(state, f"postnet.postnet.{i}.0",
                                       bias=False)
        bn = f"postnet.postnet.{i}.1"
        postnet[f"bn_{i}"] = _layernorm(state, bn)
        bn_stats[f"bn_{i}"] = {
            "mean": state[f"{bn}._mean"].astype(np.float32),
            "var": state[f"{bn}._variance"].astype(np.float32)}
    params["postnet"] = postnet
    batch_stats["postnet"] = bn_stats
    return params, batch_stats
