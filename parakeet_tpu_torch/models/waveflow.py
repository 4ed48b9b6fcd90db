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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializer import _TRUNC_STD, init_flax_defaults_
from ..ops.geometry import time_shift

__all__ = ["UpsampleNet", "WaveFlowResidualBlock", "Flow", "WaveFlow",
           "ConditionalWaveFlow", "waveflow_loss", "fold", "unfold",
           "fold_condition", "init_waveflow_", "mm_f32"]


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) accumulated and returned in float32, for
    float32 or bf16 operands: cuBLAS's float32-output GEMM on the card;
    on the CPU the operands widened to float32 (a product of two bf16
    values is exact in float32, so this is the same function)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(*a.shape[:-1], -1)
    return a.float() @ b.float()


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
    per (offset, phase), the kernel column it reads and whether it reads
    one: (offsets, columns (O, s) int64, used (O, s) float).

    A stride-s transposed convolution with a (3, 2s) kernel and flax's
    SAME padding (3s - 2 in all, the odd element low: ``pad_lo`` =
    (3s - 1) // 2) makes output frame n s + r from input frames n + m_r
    and n + m_r + 1 with kernel columns j_r and j_r + s."""
    pad_lo = (3 * s - 1) // 2
    taps = []
    for r in range(s):
        j0 = (pad_lo - r) % s
        m0 = (r - pad_lo + j0) // s
        taps += [(m0 + t, r, j0 + t * s) for t in range(2)]
    offsets = sorted({o for o, _, _ in taps})
    columns = torch.zeros((len(offsets), s), dtype=torch.int64)
    used = torch.zeros((len(offsets), s))
    for o, r, j in taps:
        columns[offsets.index(o), r] = j
        used[offsets.index(o), r] = 1.0
    return offsets, columns, used


class UpsampleNet(nn.Module):
    """Mel (B, N, F) -> (B, N prod(factors), F): each stage a stride-s
    transposed 2-D convolution (time x frequency, a (3, 2s) kernel over
    (frequency, time)) with one bias, then LeakyReLU(0.4).

    As in the JAX module, each stage is computed polyphase at frame rate:
    output phase r of frame n reads two input frames and three frequency
    neighbours, so a stage is 3 x (offsets) shifted copies of the input
    contracted with an (offsets x 3, s) table of kernel values.  The
    parameters keep flax's raw shapes: ``deconv_{i}_kernel`` (3, 2s, 1, 1)
    and ``deconv_{i}_bias`` (1,).
    """

    def __init__(self, upsample_factors: Sequence[int] = (16, 16)):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.offsets = []
        for i, s in enumerate(self.upsample_factors):
            self.register_parameter(f"deconv_{i}_kernel", nn.Parameter(
                torch.zeros(3, 2 * s, 1, 1)))
            self.register_parameter(f"deconv_{i}_bias",
                                    nn.Parameter(torch.zeros(1)))
            offsets, columns, used = _polyphase_taps(s)
            self.offsets.append(offsets)
            self.register_buffer(f"columns_{i}", columns, persistent=False)
            self.register_buffer(f"used_{i}", used, persistent=False)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_factors)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.to(getattr(self, "deconv_0_bias").dtype)
        for i, s in enumerate(self.upsample_factors):
            kernel = getattr(self, f"deconv_{i}_kernel")[..., 0, 0]  # (3, 2s)
            table = (kernel[:, getattr(self, f"columns_{i}")]
                     * getattr(self, f"used_{i}"))            # (3, O, s)
            table = table.transpose(0, 1).reshape(-1, s)      # (O 3, s)
            b, n, f = x.shape
            xpad = F.pad(x, (1, 1, 2, 2))
            shifted = torch.stack([xpad[:, 2 + o:2 + o + n, dh:dh + f]
                                   for o in self.offsets[i]
                                   for dh in range(3)])       # (O 3, B, N, F)
            y = torch.einsum("kbnf,ks->bnsf", shifted, table)
            x = F.leaky_relu(y.reshape(b, n * s, f)
                             + getattr(self, f"deconv_{i}_bias"), 0.4)
        return x


class WaveFlowResidualBlock(nn.Module):
    """Gated 2-D convolution layer, causal in height, SAME and dilated in
    width, on channels-last grids.  ``conv`` is VALID: ``forward`` pads
    the full grid (``grid_conv``), ``step`` computes one row from the
    rows the sampler carries."""

    def __init__(self, channels: int, cond_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3), dilation_w: int = 1,
                 dilation_h: int = 1):
        super().__init__()
        self.channels = channels
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
        as its (B, C, h, W) view, channels-last in memory."""
        w_pad = (self.kernel_size[1] - 1) * self.dilation_w // 2
        xp = F.pad(x.permute(0, 3, 1, 2), (w_pad, w_pad, self.buffer_rows, 0))
        return self.conv(xp).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, condition: torch.Tensor):
        """x (B, h, W, C), condition (B, h, W, C_cond) -> (x + residual,
        skip), each (B, h, W, C)."""
        c = self.channels
        h = self.grid_conv(x) + F.linear(
            condition, self.condition_proj.weight[:, :, 0, 0],
            self.condition_proj.bias)
        out = F.linear(torch.tanh(h[..., :c]) * torch.sigmoid(h[..., c:]),
                       self.out_proj.weight[:, :, 0, 0], self.out_proj.bias)
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
                 sample_act_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers, self.channels = n_layers, channels
        self.sample_act_dtype = sample_act_dtype
        dil_h = tuple(dilations_h) or (1,) * n_layers
        self.input_proj = nn.Conv2d(1, channels, 1)
        for i in range(n_layers):
            self.add_module(f"resnet_{i}", WaveFlowResidualBlock(
                channels, mel_bands, kernel_size, dilation_w=2 ** i,
                dilation_h=dil_h[i]))
        self.output_proj = nn.Conv2d(channels, 2, 1)

    def blocks(self):
        return [getattr(self, f"resnet_{i}") for i in range(self.n_layers)]

    def _net(self, x, condition):
        """x (B, h, W), condition (B, h, W, C_cond) -> (logs, b), each
        (B, h, W); output row i reads input rows <= i."""
        h = (x[..., None] * self.input_proj.weight.reshape(self.channels)
             + self.input_proj.bias)
        skips = 0.0
        for block in self.blocks():
            h, skip = block(h, condition)
            skips = skips + skip
        out = F.linear(skips, self.output_proj.weight[:, :, 0, 0],
                       self.output_proj.bias)
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
        adt = self.sample_act_dtype or f32
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
                cond_g = condition[:, i] @ wts["ck"] + wts["cb"]
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
                 sample_act_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_flows, self.n_group = n_flows, n_group
        base = self.dilations_dict.get(n_group, (1,) * n_layers)
        dil_h = tuple(base[i % len(base)] for i in range(n_layers))
        for i in range(n_flows):
            self.add_module(f"flows_{i}", Flow(
                n_layers, channels, mel_bands, kernel_size, dil_h,
                sample_act_dtype))

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
                 sample_act_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_group, self.sigma = n_group, sigma
        self.encoder = UpsampleNet(upsample_factors)
        self.decoder = WaveFlow(n_flows, n_layers, n_group, channels, n_mels,
                                kernel_size, sample_act_dtype)

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
