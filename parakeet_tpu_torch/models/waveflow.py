"""WaveFlow (counterpart of ``parakeet_tpu/models/waveflow.py``; reference:
parakeet/models/waveflow.py:32-909): a flow-based vocoder, mel -> wave.

Audio is folded into an (n_group x W) grid; 8 affine-coupling flows, each
a WaveNet of 2-D convolutions causal in height (the group axis) and
dilated in width, conditioned on the upsampled mel; rows are permuted
between flows.  Submodules and parameters keep the flax names
(``encoder.deconv_{i}_kernel``, ``decoder.flows_{i}.resnet_{j}.conv``,
...), so ``bridge.py`` loads a JAX checkpoint.

- The density direction (training) keeps the grid channels-last,
  (B, h, W, C), as the JAX module's NHWC: the 1 x 1 projections are
  products over the last axis, and each layer's height-causal,
  width-dilated 3 x 3 convolution is one ``Conv2d`` on the grid's
  (B, C, h, W) view, padded causally in height and SAME in width, which
  cuDNN runs with its channels-last kernels (with cuDNN off, the
  recipes' bitwise-resume setting, PyTorch's native convolution).  The
  same convolution as cuBLAS products of its taps took 1.6× (cuDNN on)
  and 5.2× (off) as long a step (``tools/waveflow_step_forms.py``).
- Synthesis inverts each flow one row at a time, as the JAX ``lax.scan``
  does, carrying each layer's last (kh - 1) dh input rows in a flat
  (B, W, rows x C) buffer, so exactly one new row flows through the
  stack a step; the row's convolution is kw shifted products with the
  kh height taps folded into the contraction.  The loop is unrolled in
  Python with static shapes and reads nothing back to the host, so the
  whole sampler (8 flows x 15 rows x 8 layers) may be captured in one
  CUDA graph whose inputs are the mel and the noise.
- ``sample_act_dtype`` (bf16) runs the sampler's carried activations and
  the operands of its tap products and output projections in that type;
  as in the JAX module (``preferred_element_type=float32``), each product
  accumulates and returns float32 (``mm_f32``), and the conditioning, the
  skips and the affine inversion stay in the parameters' float32.
- ``dtype`` is flax's (``nn/precision.py``): with ``torch.bfloat16`` the
  parameters stay float32, and the upsampler, the input, residual,
  conditioning and output projections compute in bf16 where the JAX
  module does (its cast points: the upsampler and
  ``WaveFlowResidualBlock``), so (logs, b) and the log-determinant are
  bf16 while z and the loss are float32; the sampler's activations then
  default to bf16 as well.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializer import _TRUNC_STD, init_flax_defaults_
from ..nn.precision import cast, dense, mm_f32, sigmoid
from ..ops.geometry import time_shift

__all__ = ["UpsampleNet", "WaveFlowResidualBlock", "Flow", "WaveFlow",
           "ConditionalWaveFlow", "waveflow_loss", "fold", "unfold",
           "fold_condition", "init_waveflow_", "mm_f32"]


def fold(x: torch.Tensor, n_group: int) -> torch.Tensor:
    """(B, T) -> (B, n_group, T // n_group); consecutive samples run down
    the height axis."""
    b, t = x.shape
    w = t // n_group
    return x[:, :w * n_group].reshape(b, w, n_group).transpose(1, 2)


def unfold(x: torch.Tensor) -> torch.Tensor:
    """(B, n_group, W) -> (B, n_group * W), the inverse of ``fold``."""
    b, h, w = x.shape
    return x.transpose(1, 2).reshape(b, h * w)


def fold_condition(condition: torch.Tensor, n_group: int) -> torch.Tensor:
    """(B, T, C) -> (B, n_group, W, C), matching ``fold``."""
    b, t, c = condition.shape
    w = t // n_group
    return condition[:, :w * n_group].reshape(b, w, n_group, c).transpose(
        1, 2)


def _polyphase_taps(s: int):
    """The frame offsets of one stride-``s`` stage of ``UpsampleNet`` and,
    per tap t (0, 1) and phase r, the offset it reads and its kernel
    column: (offsets, rows (2, s) int64 into offsets, columns (2, s)
    int64).

    A stride-s transposed convolution with a (3, 2s) kernel and flax's
    SAME padding (3s - 2 in all, the odd element low: ``pad_lo`` =
    (3s - 1) // 2) makes output frame n s + r from input frames n + m_r
    and n + m_r + 1 with kernel columns j_r and j_r + s."""
    pad_lo = (3 * s - 1) // 2
    taps = []
    for r in range(s):
        j0 = (pad_lo - r) % s
        m0 = (r - pad_lo + j0) // s
        taps.append([(m0 + t, j0 + t * s) for t in range(2)])
    offsets = sorted({o for tap in taps for o, _ in tap})
    rows = torch.tensor([[offsets.index(tap[t][0]) for tap in taps]
                         for t in range(2)])
    columns = torch.tensor([[tap[t][1] for tap in taps] for t in range(2)])
    return offsets, rows, columns


class UpsampleNet(nn.Module):
    """Mel (B, N, F) -> (B, N prod(factors), F): each stage a stride-s
    transposed 2-D convolution (time x frequency, a (3, 2s) kernel over
    (frequency, time)) with one bias, then LeakyReLU(0.4).

    As in the JAX module, each stage is computed polyphase at frame rate:
    output phase r of frame n reads two input frames and three frequency
    neighbours, so a stage is six multiply-adds of shifted copies of the
    input, all phases at once, summed in the JAX module's order in the
    compute dtype (each product and sum rounded to it).  The parameters
    keep flax's raw shapes: ``deconv_{i}_kernel`` (3, 2s, 1, 1) and
    ``deconv_{i}_bias`` (1,).
    """

    def __init__(self, upsample_factors: Sequence[int] = (16, 16),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.dtype = dtype
        self.offsets = []
        for i, s in enumerate(self.upsample_factors):
            self.register_parameter(f"deconv_{i}_kernel", nn.Parameter(
                torch.zeros(3, 2 * s, 1, 1)))
            self.register_parameter(f"deconv_{i}_bias",
                                    nn.Parameter(torch.zeros(1)))
            offsets, rows, columns = _polyphase_taps(s)
            self.offsets.append(offsets)
            self.register_buffer(f"rows_{i}", rows, persistent=False)
            self.register_buffer(f"columns_{i}", columns, persistent=False)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_factors)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or getattr(self, "deconv_0_bias").dtype
        x = mel.to(dt)
        for i, s in enumerate(self.upsample_factors):
            kernel = cast(getattr(self, f"deconv_{i}_kernel"), dt)[..., 0, 0]
            rows = getattr(self, f"rows_{i}")
            columns = getattr(self, f"columns_{i}")
            b, n, f = x.shape
            xpad = F.pad(x, (1, 1, 2, 2))
            frames = torch.stack([xpad[:, 2 + o:2 + o + n]
                                  for o in self.offsets[i]])  # (O, B, N, F+2)
            acc = None
            for t in range(2):
                x_t = frames[rows[t]]                         # (s, B, N, F+2)
                k_t = kernel[:, columns[t], None, None, None]  # (3, s, 1, 1, 1)
                for dh in range(3):
                    p = x_t[..., dh:dh + f] * k_t[dh]
                    acc = p if acc is None else acc + p
            y = acc.permute(1, 2, 0, 3)                       # (B, N, s, F)
            y = (y.reshape(b, n * s, f)
                 + cast(getattr(self, f"deconv_{i}_bias"), dt))
            # flax's leaky_relu: the slope rounded to y's dtype
            slope = torch.tensor(0.4, dtype=dt).item()
            x = torch.where(y >= 0, y, y * slope)
        return x


class WaveFlowResidualBlock(nn.Module):
    """Gated 2-D convolution layer, causal in height, SAME and dilated in
    width, on channels-last grids.  ``conv`` is VALID: ``forward`` pads
    the full grid (``grid_conv``), ``step`` computes one row from the
    rows the sampler carries."""

    def __init__(self, channels: int, cond_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3), dilation_w: int = 1,
                 dilation_h: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.channels = channels
        self.dtype = dtype
        self.kernel_size = tuple(kernel_size)
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self.conv = nn.Conv2d(channels, 2 * channels, self.kernel_size,
                              dilation=(dilation_h, dilation_w))
        self.condition_proj = nn.Conv2d(cond_channels, 2 * channels, 1)
        self.out_proj = nn.Conv2d(channels, 2 * channels, 1)

    @property
    def buffer_rows(self) -> int:
        """Rows of history the sampler carries: the height receptive field
        less the current row."""
        return (self.kernel_size[0] - 1) * self.dilation_h

    def grid_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution of x (B, h, W, C), padded causally in height
        and SAME in width: (B, h, W, 2C).  The grid is handed to ``conv``
        as its (B, C, h, W) view, channels-last in memory.  With a
        ``dtype`` the kh x kw taps, shifted copies of the padded grid
        side by side, go through one product with the (kh kw C, 2C)
        kernel in that dtype (accumulated in float32, rounded once, as a
        convolution in it): cuDNN's bf16 kernels for this width-dilated
        convolution fell back to a direct kernel, 60x slower than the
        float32 step on an H100 (PERF.md)."""
        w_pad = (self.kernel_size[1] - 1) * self.dilation_w // 2
        if self.dtype is None:
            xp = F.pad(x.permute(0, 3, 1, 2),
                       (w_pad, w_pad, self.buffer_rows, 0))
            return self.conv(xp).permute(0, 2, 3, 1)
        kh, kw = self.kernel_size
        h, w = x.shape[1], x.shape[2]
        xp = F.pad(x.to(self.dtype), (0, 0, w_pad, w_pad,
                                      self.buffer_rows, 0))
        taps = torch.cat([xp[:, i * self.dilation_h:i * self.dilation_h + h,
                             j * self.dilation_w:j * self.dilation_w + w]
                          for i in range(kh) for j in range(kw)], dim=-1)
        kernel = self.conv.weight.permute(0, 2, 3, 1).reshape(
            self.conv.weight.shape[0], -1)              # (2C, kh kw C)
        return dense(taps, kernel, self.conv.bias, self.dtype)

    def forward(self, x: torch.Tensor, condition: torch.Tensor):
        """x (B, h, W, C), condition (B, h, W, C_cond) -> (x + residual,
        skip), each (B, h, W, C)."""
        c = self.channels
        h = self.grid_conv(x) + dense(
            condition, self.condition_proj.weight[:, :, 0, 0],
            self.condition_proj.bias, self.dtype)
        out = dense(torch.tanh(h[..., :c]) * sigmoid(h[..., c:]),
                    self.out_proj.weight[:, :, 0, 0], self.out_proj.bias,
                    self.dtype)
        return x + out[..., :c], out[..., c:]

    def step_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The weights of ``step`` in its flat layout, made once a flow
        before its rows: the convolution as (kw, kh C, 2C) in ``dtype``
        and its bias, the conditioning projection (C_cond, 2C) and its
        bias, the output projection (C, 2C) in ``dtype`` and its bias."""
        kh, kw = self.kernel_size
        w = self.conv.weight                           # (2C, C, kh, kw)
        return {
            "kmat": w.permute(3, 2, 1, 0).reshape(kw, kh * self.channels,
                                                  -1).to(dtype).contiguous(),
            "bias": self.conv.bias,
            "ck": self.condition_proj.weight[:, :, 0, 0].t().contiguous(),
            "cb": self.condition_proj.bias,
            "okern": self.out_proj.weight[:, :, 0, 0].t().to(
                dtype).contiguous(),
            "obias": self.out_proj.bias}

    def step(self, rows: torch.Tensor, cond_gate_row: torch.Tensor,
             weights: Dict[str, torch.Tensor]):
        """One sampler row.  ``rows`` (B, W, (buffer_rows + 1) C): this
        layer's input over its last rows, oldest first (the current row
        last); with height dilation only every dilation_h-th row feeds the
        taps.  ``cond_gate_row`` (B, W, 2C) float32: the row's projected
        conditioning.  Returns (residual row (B, W, C) in rows' type, skip
        row (B, W, C) float32)."""
        c = self.channels
        kh, kw = self.kernel_size
        if self.dilation_h > 1:
            rows_in = torch.cat([rows[..., i * self.dilation_h * c:
                                      (i * self.dilation_h + 1) * c]
                                 for i in range(kh)], dim=-1)
        else:
            rows_in = rows
        acc = None
        for dw in range(kw):
            off = (dw - (kw - 1) // 2) * self.dilation_w
            y = mm_f32(time_shift(rows_in, off), weights["kmat"][dw])
            acc = y if acc is None else acc + y
        h = acc + weights["bias"] + cond_gate_row
        gate = (torch.tanh(h[..., :c]) * torch.sigmoid(h[..., c:])).to(
            rows.dtype)
        out = mm_f32(gate, weights["okern"]) + weights["obias"]
        return rows[..., -c:] + out[..., :c].to(rows.dtype), out[..., c:]


class Flow(nn.Module):
    """One affine-coupling flow: row 0 passes, row i > 0 is scaled and
    shifted by (logs, b) computed from the rows before it and its own
    condition.  ``output_proj`` starts at zero (the identity flow)."""

    def __init__(self, n_layers: int = 8, channels: int = 64,
                 mel_bands: int = 80, kernel_size: Tuple[int, int] = (3, 3),
                 dilations_h: Sequence[int] = (),
                 sample_act_dtype: Optional[torch.dtype] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers, self.channels = n_layers, channels
        self.sample_act_dtype, self.dtype = sample_act_dtype, dtype
        dil_h = tuple(dilations_h) or (1,) * n_layers
        self.input_proj = nn.Conv2d(1, channels, 1)
        for i in range(n_layers):
            self.add_module(f"resnet_{i}", WaveFlowResidualBlock(
                channels, mel_bands, kernel_size, dilation_w=2 ** i,
                dilation_h=dil_h[i], dtype=dtype))
        self.output_proj = nn.Conv2d(channels, 2, 1)

    def blocks(self):
        return [getattr(self, f"resnet_{i}") for i in range(self.n_layers)]

    def _net(self, x, condition):
        """x (B, h, W), condition (B, h, W, C_cond) -> (logs, b), each
        (B, h, W); output row i reads input rows <= i."""
        dt = self.dtype or self.input_proj.weight.dtype
        h = (x.to(dt)[..., None] * self.input_proj.weight.reshape(
            self.channels).to(dt) + self.input_proj.bias.to(dt))
        skips = 0.0
        for block in self.blocks():
            h, skip = block(h, condition)
            skips = skips + skip
        out = dense(skips, self.output_proj.weight[:, :, 0, 0],
                    self.output_proj.bias, self.dtype)
        return out[..., 0], out[..., 1]

    def forward(self, x: torch.Tensor, condition: torch.Tensor):
        """Density direction: x (B, h, W) -> (z, logs (B, h - 1, W)); row
        i > 0 uses rows < i of x and row i of the condition."""
        logs, b = self._net(x[:, :-1], condition[:, 1:])
        z = torch.cat([x[:, :1], x[:, 1:] * torch.exp(logs) + b], dim=1)
        return z, logs

    def inverse(self, z: torch.Tensor, condition: torch.Tensor):
        """Sampling direction: z (B, h, W) -> x, one row at a time."""
        b, h, w = z.shape
        c = self.channels
        f32 = self.input_proj.weight.dtype
        adt = self.sample_act_dtype or self.dtype or f32
        blocks = self.blocks()
        weights = [block.step_weights(adt) for block in blocks]
        ikern = self.input_proj.weight.reshape(c)
        ibias = self.input_proj.bias
        okern = self.output_proj.weight[:, :, 0, 0].t()     # (C, 2)
        obias = self.output_proj.bias
        bufs = [torch.zeros((b, w, block.buffer_rows * c), dtype=adt,
                            device=z.device) for block in blocks]
        x_prev = z[:, 0]
        out_rows = [x_prev]
        for i in range(1, h):
            h_row = (x_prev[..., None] * ikern + ibias).to(adt)
            skips = 0.0
            for j, block in enumerate(blocks):
                rows = torch.cat([bufs[j], h_row], dim=-1)
                bufs[j] = rows[..., c:]
                wts = weights[j]
                cond_g = condition[:, i].to(f32) @ wts["ck"] + wts["cb"]
                h_row, skip = block.step(rows, cond_g, wts)
                skips = skips + skip
            out = skips @ okern + obias                      # (B, W, 2)
            x_prev = (z[:, i] - out[..., 1]) * torch.exp(-out[..., 0])
            out_rows.append(x_prev)
        return torch.stack(out_rows, dim=1)


def _permute_rows(x: torch.Tensor, flow_index: int,
                  n_flows: int) -> torch.Tensor:
    """The fixed permutation of the rows (axis 1) after flow
    ``flow_index``: the first half of the flows reverse the rows, the
    second half reverse each half of them.  Both are their own inverse."""
    if flow_index < n_flows // 2:
        return x.flip(1)
    half = x.shape[1] // 2
    return torch.cat([x[:, :half].flip(1), x[:, half:].flip(1)], dim=1)


class WaveFlow(nn.Module):
    """Flows with row permutations; ``dilations_dict`` gives the layers'
    height dilations by n_group (the pattern cycles over other depths)."""

    dilations_dict = {
        8: (1, 1, 1, 1, 1, 1, 1, 1),
        16: (1, 1, 1, 1, 1, 1, 1, 1),
        32: (1, 2, 4, 1, 2, 4, 1, 2),
        64: (1, 2, 4, 8, 16, 1, 2, 4),
        128: (1, 2, 4, 8, 16, 32, 64, 1),
    }

    def __init__(self, n_flows: int = 8, n_layers: int = 8,
                 n_group: int = 16, channels: int = 64, mel_bands: int = 80,
                 kernel_size: Tuple[int, int] = (3, 3),
                 sample_act_dtype: Optional[torch.dtype] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_flows, self.n_group = n_flows, n_group
        base = self.dilations_dict.get(n_group, (1,) * n_layers)
        dil_h = tuple(base[i % len(base)] for i in range(n_layers))
        for i in range(n_flows):
            self.add_module(f"flows_{i}", Flow(
                n_layers, channels, mel_bands, kernel_size, dil_h,
                sample_act_dtype, dtype))

    def flows(self):
        return [getattr(self, f"flows_{i}") for i in range(self.n_flows)]

    def forward(self, x: torch.Tensor, condition: torch.Tensor):
        """x (B, T) audio, condition (B, T, C) -> (z (B, T), logs summed
        over each utterance (B,))."""
        z = fold(x, self.n_group)
        cond = fold_condition(condition, self.n_group)
        logs_sum = 0.0
        for i, flow in enumerate(self.flows()):
            z, logs = flow(z, cond)
            logs_sum = logs_sum + logs.sum(dim=(1, 2))
            z = _permute_rows(z, i, self.n_flows)
            cond = _permute_rows(cond, i, self.n_flows)
        return unfold(z), logs_sum

    def inverse(self, z: torch.Tensor, condition: torch.Tensor):
        """z (B, T) noise, condition (B, T, C) -> audio (B, T)."""
        x = fold(z, self.n_group)
        conds = [fold_condition(condition, self.n_group).contiguous()]
        for i in range(self.n_flows - 1):
            conds.append(_permute_rows(conds[-1], i, self.n_flows))
        for i in reversed(range(self.n_flows)):
            x = _permute_rows(x, i, self.n_flows)
            x = self.flows()[i].inverse(x, conds[i])
        return unfold(x)


class ConditionalWaveFlow(nn.Module):
    """``UpsampleNet`` encoder and ``WaveFlow`` decoder; constructor
    arguments keep the JAX module's (and the recipe YAML's) names."""

    def __init__(self, upsample_factors: Sequence[int] = (16, 16),
                 n_flows: int = 8, n_layers: int = 8, n_group: int = 16,
                 channels: int = 64, n_mels: int = 80,
                 kernel_size: Tuple[int, int] = (3, 3), sigma: float = 1.0,
                 sample_act_dtype: Optional[torch.dtype] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_group, self.sigma = n_group, sigma
        self.encoder = UpsampleNet(upsample_factors, dtype)
        self.decoder = WaveFlow(n_flows, n_layers, n_group, channels, n_mels,
                                kernel_size, sample_act_dtype, dtype)

    def forward(self, audio: torch.Tensor, mel: torch.Tensor):
        """audio (B, T), mel (B, T_mel, C) -> (z, logs_sum)."""
        condition = self.encoder(mel)
        t = min(audio.shape[1], condition.shape[1])
        t = (t // self.n_group) * self.n_group
        return self.decoder(audio[:, :t], condition[:, :t])

    def samples(self, frames: int) -> int:
        """Samples ``infer`` makes from ``frames`` mel frames."""
        t = frames * self.encoder.upsample_factor
        return (t // self.n_group) * self.n_group

    def infer(self, mel: torch.Tensor, rng: Optional[torch.Generator] = None,
              *, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel (B, T_mel, C) -> audio (B, ``samples(T_mel)``).  The noise
        is ``sigma`` times ``noise`` (B, samples), when the caller passes
        it (a captured sampler's input buffer), else a standard normal
        drawn from ``rng``."""
        condition = self.encoder(mel)
        t = self.samples(mel.shape[1])
        if noise is None:
            noise = torch.randn((mel.shape[0], t), generator=rng,
                                dtype=condition.dtype, device=mel.device)
        return self.decoder.inverse(self.sigma * noise, condition[:, :t])


@torch.no_grad()
def init_waveflow_(model: ConditionalWaveFlow, gen: torch.Generator) -> None:
    """flax's initializers for the JAX module, from ``gen`` (a CPU
    generator): convolution kernels lecun-normal over their fan-in, the
    upsampler's raw kernels over theirs (3 x 2s), biases zero, and each
    flow's ``output_proj`` zero (an identity flow)."""
    init_flax_defaults_(model, gen)
    for i, s in enumerate(model.encoder.upsample_factors):
        kernel = getattr(model.encoder, f"deconv_{i}_kernel")
        std = math.sqrt(1.0 / (3 * 2 * s)) / _TRUNC_STD
        kernel.copy_(torch.nn.init.trunc_normal_(
            torch.empty(kernel.shape), 0.0, std, -2 * std, 2 * std,
            generator=gen))
        getattr(model.encoder, f"deconv_{i}_bias").zero_()
    for flow in model.decoder.flows():
        flow.output_proj.weight.zero_()
        flow.output_proj.bias.zero_()


def waveflow_loss(z: torch.Tensor, logs_sum: torch.Tensor,
                  sigma: float = 1.0) -> Dict[str, torch.Tensor]:
    """Negative log-likelihood a sample: z^2 / (2 sigma^2) - log det +
    log(2 pi) / 2 + log sigma; returns loss, nll and logdet."""
    n = z.shape[0] * z.shape[1]
    const = 0.5 * math.log(2 * math.pi) + math.log(sigma)
    nll = torch.square(z).sum() / (2 * sigma * sigma)
    logdet = logs_sum.sum()
    return {"loss": (nll - logdet) / n + const, "nll": nll / n + const,
            "logdet": logdet / n}
