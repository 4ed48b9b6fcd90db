"""Parallel WaveGAN generator and discriminator (counterpart of
``parakeet_tpu/models/parallel_wavegan.py``).

The formulation follows the JAX package, not PyTorch's convolution
layers: dilated convolutions are shifted matmuls (``conv1d_taps``), the
upsampler is computed polyphase at frame rate, and weight norm is an
explicit (kernel, scale) pair.  Parameters therefore keep the flax
layouts ((k, Cin, Cout) kernels; the residual stack's stacked over layers
as (L, ...)), and ``bridge.load_flax_params`` copies them as they are.
Kernels start at zero: load or initialize weights before use.

The compute dtype is the parameters' dtype (``module.to(torch.bfloat16)``);
weight norm is always folded in float32.  Products take their operands in
the compute dtype and accumulate in float32, like ``jnp.dot(...,
preferred_element_type=float32)``.  Not ported: dropout, the causal
variant and ``ResidualPWGDiscriminator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geometry import time_shift as _shift
from ..ops.kernels.pwg_disc import (VJP_MODES, fused_disc_supported,
                                    fused_disc_tail)
from ..ops.kernels.pwg_stack import (fused_residual_stack,
                                     fused_stack_supported)
from ..ops.kernels.pwg_stack_train import fused_residual_stack_train

__all__ = ["PWGGenerator", "PWGDiscriminator", "pwg_inference",
           "conv1d_taps", "WNConv1d", "UpsampleNet", "ConvInUpsampleNet",
           "ResidualStack", "edge_pad", "stack_route", "init_pwg_params_"]

_WN_EPS = 1e-12
_F32 = torch.float32


def _wn(kernel: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Weight norm over all axes but the last: scale * k / ||k||, in
    float32."""
    kernel = kernel.to(_F32)
    if scale is None:
        return kernel
    axes = tuple(range(kernel.ndim - 1))
    norm = torch.sqrt((kernel * kernel).sum(axes, keepdim=True) + _WN_EPS)
    return kernel * (scale.to(_F32) / norm)


def _wn_stacked(kernel: torch.Tensor,
                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``_wn`` of each layer of an (L, ..., Cout) stacked kernel."""
    kernel = kernel.to(_F32)
    if scale is None:
        return kernel
    axes = tuple(range(1, kernel.ndim - 1))
    norm = torch.sqrt((kernel * kernel).sum(axes, keepdim=True) + _WN_EPS)
    shape = (scale.shape[0],) + (1,) * (kernel.ndim - 2) + (scale.shape[1],)
    return kernel * (scale.to(_F32).reshape(shape) / norm)


def _dot(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype):
    """a @ w with operands rounded to ``dtype`` and a float32 result."""
    return a.to(dtype).to(_F32) @ w.to(dtype).to(_F32)


def conv1d_taps(x: torch.Tensor, kernel: torch.Tensor, dilation: int = 1,
                padding: str = "SAME",
                dtype: torch.dtype = _F32) -> torch.Tensor:
    """Dilated 1-D conv as k shifted matmuls; x (B, T, Cin), kernel
    (k, Cin, Cout).  SAME is zero-padded and needs an odd k; VALID
    returns T - (k - 1) * dilation frames.  Accumulates in float32 and
    returns ``dtype``."""
    k = kernel.shape[0]
    acc = None
    if padding == "SAME":
        if k % 2 != 1:
            raise ValueError("SAME padding requires an odd kernel size")
        for j in range(k):
            y = _dot(_shift(x, (j - k // 2) * dilation), kernel[j], dtype)
            acc = y if acc is None else acc + y
    elif padding == "VALID":
        out_t = x.shape[1] - (k - 1) * dilation
        for j in range(k):
            y = _dot(x[:, j * dilation:j * dilation + out_t], kernel[j],
                     dtype)
            acc = y if acc is None else acc + y
    else:
        raise ValueError(f"unsupported padding {padding!r}")
    return acc.to(dtype)


class WNConv1d(nn.Module):
    """Weight-normalized dilated conv via shifted matmuls, (B, T, C)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 dilation: int = 1, padding: str = "SAME",
                 use_bias: bool = True, use_weight_norm: bool = True):
        super().__init__()
        self.dilation, self.padding = dilation, padding
        self.kernel = nn.Parameter(
            torch.zeros(kernel_size, in_features, features))
        self.scale = (nn.Parameter(torch.ones(features))
                      if use_weight_norm else None)
        self.bias = (nn.Parameter(torch.zeros(features))
                     if use_bias else None)

    def effective_weights(self):
        """(weight-norm-folded kernel, bias) in float32; the bias is zeros
        without one (what a fused kernel consumes)."""
        kernel = _wn(self.kernel, self.scale)
        bias = (self.bias.to(_F32) if self.bias is not None
                else kernel.new_zeros(kernel.shape[-1]))
        return kernel, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.kernel.dtype
        y = conv1d_taps(x, _wn(self.kernel, self.scale), self.dilation,
                        self.padding, dt)
        if self.bias is not None:
            y = y + self.bias
        return y


def _phase_masks(scale: int) -> np.ndarray:
    """(3, 2*scale+1, scale) masks: masks[m, j, r] == 1 iff FIR tap j of
    output phase r reads input frame n + m - 1 after nearest-stretch by
    ``scale`` (centered FIR)."""
    kt = 2 * scale + 1
    masks = np.zeros((3, kt, scale), np.float32)
    for r in range(scale):
        for j in range(kt):
            masks[(r + j - scale) // scale + 1, j, r] = 1.0
    return masks


class UpsampleNet(nn.Module):
    """Nearest-stretch + (2s+1)-tap FIR per scale, computed polyphase at
    frame rate; mel (B, N, F) -> (B, N * prod(scales), F).  Only the
    released configuration is ported: ``freq_axis_kernel_size=1``, no
    nonlinearity, centered FIR."""

    def __init__(self, upsample_scales: Sequence[int],
                 use_weight_norm: bool = True):
        super().__init__()
        self.upsample_scales = tuple(upsample_scales)
        self.use_weight_norm = use_weight_norm
        for i, s in enumerate(self.upsample_scales):
            self.register_parameter(f"conv_{i}_kernel", nn.Parameter(
                torch.zeros(2 * s + 1, 1, 1, 1)))
            if use_weight_norm:
                self.register_parameter(f"conv_{i}_scale",
                                        nn.Parameter(torch.ones(1)))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        dt = getattr(self, "conv_0_kernel").dtype
        x = c.to(dt)
        for i, s in enumerate(self.upsample_scales):
            kernel = getattr(self, f"conv_{i}_kernel")[..., 0, 0]  # (kt, 1)
            if self.use_weight_norm:
                w = _wn(kernel.reshape(-1, 1),
                        getattr(self, f"conv_{i}_scale"))
            else:
                w = kernel
            w = w.to(dt)
            masks = torch.as_tensor(_phase_masks(s), dtype=dt,
                                    device=x.device)
            b, n, f = x.shape
            # per-phase 3-tap comb as one (n, 3f) @ (3f, s*f) product
            km_all = torch.einsum("mjr,j->mr", masks, w[:, 0])    # (3, s)
            xs = torch.cat([_shift(x, m - 1) for m in range(3)], dim=-1)
            eye = torch.eye(f, dtype=dt, device=x.device)
            wmat = torch.einsum("mr,fg->mfrg", km_all, eye).reshape(
                3 * f, s * f)
            x = _dot(xs, wmat, dt).reshape(b, n * s, f).to(dt)
        return x


class ConvInUpsampleNet(nn.Module):
    """Context conv (VALID, k = 2w + 1, no bias: trims 2w frames), then
    ``UpsampleNet``.  The mel must carry w extra frames on both sides."""

    def __init__(self, upsample_scales: Sequence[int], aux_channels: int = 80,
                 aux_context_window: int = 2, use_weight_norm: bool = True):
        super().__init__()
        self.conv_in = WNConv1d(aux_channels, aux_channels,
                                2 * aux_context_window + 1, padding="VALID",
                                use_bias=False,
                                use_weight_norm=use_weight_norm)
        self.upsample = UpsampleNet(upsample_scales, use_weight_norm)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.upsample(self.conv_in(c))


def stack_route(impl: str, supported: bool, on_cuda: bool,
                grad_needed: bool, dropout: float = 0.0) -> str:
    """Which path ``ResidualStack`` takes: 'eager', 'k1' (the fused
    inference forward) or 'train' (the differentiable K2 groups).

    K1 writes its outputs from a kernel, outside autograd, so it runs only
    when no gradient is needed.  'fused' trains through K2 ('pallas' in
    the JAX package); 'auto' fuses only inference on CUDA, as the JAX
    'auto' fuses only deterministic calls.
    """
    if impl == "eager":
        return "eager"
    if impl == "fused":
        if not grad_needed:
            return "k1"
        if dropout != 0.0:
            raise ValueError("impl='fused' training has no dropout path; use "
                             "impl='eager' (or 'auto') when dropout > 0")
        return "train"
    if impl == "auto":
        return "k1" if supported and on_cuda and not grad_needed else "eager"
    raise ValueError(f"unknown ResidualStack impl {impl!r}")


class ResidualStack(nn.Module):
    """L gated dilated-conv residual layers with layer-stacked parameters.

    Per layer ``gate = conv_d(x) + aux(c); h = tanh(a) * sigmoid(b);
    skip += skip_conv(h); x = (out_conv(h) + x) * sqrt(0.5)``.  Returns
    (x_final, skip_sum); callers apply the sqrt(1 / L) skip scale.

    ``impl`` (see ``stack_route``): 'eager' (the JAX package's 'xla'
    layer loop, any device); 'fused' (without a gradient the K1 forward of
    ``ops/kernels/pwg_stack.py``, under autograd the K2a/K2b groups of
    ``ops/kernels/pwg_stack_train.py``: the CUDA kernels on CUDA tensors,
    their plain versions on CPU tensors); or 'auto' (K1 on CUDA tensors
    when the configuration is supported and no gradient is needed, eager
    otherwise).  ``dropout`` is accepted as the JAX module's field; the
    port has no dropout, so a non-zero value raises in training.
    """

    def __init__(self, layers: int = 30, stacks: int = 3,
                 kernel_size: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 aux_channels: Optional[int] = 80, bias: bool = True,
                 use_weight_norm: bool = True, impl: str = "auto",
                 dropout: float = 0.0):
        super().__init__()
        if impl not in ("eager", "fused", "auto"):
            raise ValueError(f"unknown ResidualStack impl {impl!r}")
        self.layers, self.stacks, self.impl = layers, stacks, impl
        self.dropout = dropout
        self.residual_channels = residual_channels
        self.skip_channels = skip_channels
        self.supported = fused_stack_supported(
            residual_channels, gate_channels, skip_channels, kernel_size,
            layers, stacks, aux_channels=aux_channels)
        if impl == "fused" and not self.supported:
            raise ValueError("fused residual stack unsupported for this "
                             "ResidualStack configuration")
        cr, cg, cs, half = (residual_channels, gate_channels, skip_channels,
                            gate_channels // 2)
        L = layers

        def p(*shape, fill=0.0):
            return nn.Parameter(torch.full(shape, fill))

        wn = use_weight_norm
        self.conv_kernel = p(L, kernel_size, cr, cg)
        self.conv_scale = p(L, cg, fill=1.0) if wn else None
        self.conv_bias = p(L, cg, fill=0.0) if bias else None
        if aux_channels is not None:
            self.aux_kernel = p(L, aux_channels, cg)
            self.aux_scale = p(L, cg, fill=1.0) if wn else None
        else:
            self.aux_kernel = self.aux_scale = None
        self.skip_kernel = p(L, half, cs)
        self.skip_scale = p(L, cs, fill=1.0) if wn else None
        self.skip_bias = p(L, cs, fill=0.0) if bias else None
        self.out_kernel = p(L, half, cr)
        self.out_scale = p(L, cr, fill=1.0) if wn else None
        self.out_bias = p(L, cr, fill=0.0) if bias else None

    def dilations(self):
        per = self.layers // self.stacks
        return tuple(2 ** (i % per) for i in range(self.layers))

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None):
        dt = self.conv_kernel.dtype
        grad_needed = torch.is_grad_enabled() and (
            x.requires_grad or (c is not None and c.requires_grad)
            or any(p.requires_grad for p in self.parameters()))
        route = stack_route(self.impl, self.supported, x.is_cuda,
                            grad_needed, self.dropout)
        if route == "eager":
            if grad_needed and self.dropout != 0.0:
                raise NotImplementedError("ResidualStack dropout is not "
                                          "ported")
            return self._eager(x, c, dt)
        if c is None:
            raise ValueError("the fused residual stack needs c")
        fused = (fused_residual_stack if route == "k1"
                 else fused_residual_stack_train)
        xf, skips = fused(x, c, self.fused_weights(),
                          dilations=self.dilations(), stacks=self.stacks)
        return xf.to(dt), skips

    def fused_weights(self):
        """The stacked effective (weight-norm-folded, float32) weights
        that ``fused_residual_stack`` takes."""
        return dict(
            conv=_wn_stacked(self.conv_kernel, self.conv_scale),
            aux=_wn_stacked(self.aux_kernel, self.aux_scale),
            skip=_wn_stacked(self.skip_kernel, self.skip_scale),
            out=_wn_stacked(self.out_kernel, self.out_scale),
            conv_b=self.conv_bias, skip_b=self.skip_bias,
            out_b=self.out_bias)

    def _eager(self, x, c, dt):
        """The JAX package's 'xla' path: one layer at a time, conv output
        rounded to the compute dtype before the biases are added."""
        half = self.conv_kernel.shape[-1] // 2
        skips = torch.zeros(x.shape[:2] + (self.skip_channels,),
                            dtype=_F32, device=x.device)
        x = x.to(dt)
        use_aux = c is not None and self.aux_kernel is not None

        def at(param, i):
            return None if param is None else param[i]

        for i, d in enumerate(self.dilations()):
            g = conv1d_taps(x, _wn(self.conv_kernel[i],
                                   at(self.conv_scale, i)),
                            d, "SAME", dt).to(_F32)
            if self.conv_bias is not None:
                g = g + self.conv_bias[i].to(_F32)
            if use_aux:
                g = g + _dot(c, _wn(self.aux_kernel[i],
                                    at(self.aux_scale, i)), dt)
            h = (torch.tanh(g[..., :half])
                 * torch.sigmoid(g[..., half:])).to(dt)
            s = _dot(h, _wn(self.skip_kernel[i], at(self.skip_scale, i)),
                     dt)
            if self.skip_bias is not None:
                s = s + self.skip_bias[i].to(_F32)
            o = _dot(h, _wn(self.out_kernel[i], at(self.out_scale, i)), dt)
            if self.out_bias is not None:
                o = o + self.out_bias[i].to(_F32)
            x = ((o + x.to(_F32)) * math.sqrt(0.5)).to(dt)
            skips = skips + s
        return x, skips


class PWGGenerator(nn.Module):
    """noise (B, T, 1) + mel (B, T', aux) -> waveform (B, T, 1), with
    T = (T' - 2 * aux_context_window) * prod(upsample_scales)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 30, stacks: int = 3,
                 residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, aux_channels: int = 80,
                 aux_context_window: int = 2, bias: bool = True,
                 use_weight_norm: bool = True,
                 upsample_scales: Sequence[int] = (4, 4, 4, 4),
                 stack_impl: str = "auto"):
        super().__init__()
        self.layers = layers
        self.aux_context_window = aux_context_window
        self.upsample_scales = tuple(upsample_scales)
        self.upsample_net = ConvInUpsampleNet(
            self.upsample_scales, aux_channels, aux_context_window,
            use_weight_norm)
        self.first_conv = WNConv1d(in_channels, residual_channels, 1,
                                   use_weight_norm=use_weight_norm)
        self.stack = ResidualStack(
            layers, stacks, kernel_size, residual_channels, gate_channels,
            skip_channels, aux_channels, bias, use_weight_norm, stack_impl)
        self.last_conv_0 = WNConv1d(skip_channels, skip_channels, 1,
                                    use_weight_norm=use_weight_norm)
        self.last_conv_1 = WNConv1d(skip_channels, out_channels, 1,
                                    use_weight_norm=use_weight_norm)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        dt = self.first_conv.kernel.dtype
        c = self.upsample_net(c)
        x = self.first_conv(x)
        x, skips = self.stack(x, c)
        skips = skips * math.sqrt(1.0 / self.layers)
        h = F.relu(skips).to(dt)
        h = F.relu(self.last_conv_0(h))
        return self.last_conv_1(h)


def edge_pad(mel: torch.Tensor, w: int) -> torch.Tensor:
    """Replicate the first and last frame ``w`` times: (B, T, C) ->
    (B, T + 2w, C), like ``jnp.pad(..., mode="edge")`` on the time axis."""
    t = mel.shape[1]
    idx = torch.arange(-w, t + w, device=mel.device).clamp(0, t - 1)
    return mel[:, idx]


def pwg_inference(generator: PWGGenerator, mel: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """mel (T', aux) or (B, T', aux) -> waveform (T' * hop,) or (B, ...).

    Pads ``aux_context_window`` frames on each side by replication, as the
    JAX package does.  Without ``noise`` it is drawn from ``rng``.
    """
    squeeze = mel.ndim == 2
    if squeeze:
        mel = mel[None]
    w = generator.aux_context_window
    t_out = mel.shape[1] * generator.upsample_factor
    if noise is None:
        noise = torch.randn((mel.shape[0], t_out, 1), generator=rng,
                            device=mel.device)
    wav = generator(noise, edge_pad(mel, w))
    return wav[0, :, 0] if squeeze else wav[..., 0]


class PWGDiscriminator(nn.Module):
    """Stack of dilated convs + LeakyReLU; (B, T, 1) -> (B, T, 1) logits.

    Submodules carry the flax names (``conv_0`` .. ``conv_{layers-2}``,
    ``conv_last``), so ``bridge.load_flax_params`` loads the JAX tree.
    ``impl``: 'eager' (per-layer shifted matmuls in the parameters' dtype,
    the JAX package's 'xla'), 'fused' (layer 0 in PyTorch, layers 1..9
    through ``ops/kernels/pwg_disc.py``: kernels K3a/K3b on CUDA tensors,
    their plain versions on CPU tensors) or 'auto' (fused on CUDA tensors
    at float32 when the configuration is supported, eager otherwise, as
    the JAX 'auto' fuses only at float32).  ``vjp_mode`` picks the fused
    route's backward, as the JAX field: 'save' (K3a saves every layer's
    input, K3b reads them) or 'recompute' (K3a saves nothing, K3c rebuilds
    the inputs from the layer-0 output).
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 10,
                 conv_channels: int = 64, dilation_factor: int = 1,
                 negative_slope: float = 0.2, bias: bool = True,
                 use_weight_norm: bool = True, impl: str = "eager",
                 vjp_mode: str = "save"):
        super().__init__()
        if impl not in ("eager", "fused", "auto"):
            raise ValueError(f"unknown PWGDiscriminator impl {impl!r}")
        if vjp_mode not in VJP_MODES:
            raise ValueError(f"vjp_mode must be one of {VJP_MODES}, got "
                             f"{vjp_mode!r}")
        self.layers, self.impl, self.vjp_mode = layers, impl, vjp_mode
        self.negative_slope = negative_slope
        self.supported = fused_disc_supported(
            in_channels, out_channels, kernel_size, layers, conv_channels,
            dilation_factor)
        if impl == "fused" and not self.supported:
            raise ValueError("fused discriminator unsupported for this "
                             "PWGDiscriminator configuration")
        cin = in_channels
        for i in range(layers - 1):
            dilation = 1 if i == 0 else (
                i if dilation_factor == 1 else dilation_factor ** i)
            self.add_module(f"conv_{i}", WNConv1d(
                cin, conv_channels, kernel_size, dilation, use_bias=bias,
                use_weight_norm=use_weight_norm))
            cin = conv_channels
        self.conv_last = WNConv1d(cin, out_channels, kernel_size, 1,
                                  use_bias=bias,
                                  use_weight_norm=use_weight_norm)

    def convs(self):
        return [getattr(self, f"conv_{i}") for i in range(self.layers - 1)] + [
            self.conv_last]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        slope = self.negative_slope
        convs = self.convs()
        dt = convs[0].kernel.dtype
        fused = self.impl == "fused" or (
            self.impl == "auto" and self.supported and x.is_cuda
            and dt == _F32)
        if fused:
            h = F.leaky_relu(convs[0](x), slope)
            weights = [conv.effective_weights() for conv in convs[1:]]
            logits = fused_disc_tail(h, [k for k, _ in weights],
                                     [b for _, b in weights],
                                     negative_slope=slope,
                                     vjp_mode=self.vjp_mode)
            return logits.to(dt)
        h = x
        for conv in convs[:-1]:
            h = F.leaky_relu(conv(h), slope)
        return convs[-1](h)


# flax's lecun_normal: a normal truncated at two standard deviations, whose
# standard deviation is then sqrt(1 / fan_in) (0.8796 is the truncated
# unit normal's)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_pwg_params_(module: nn.Module, gen: torch.Generator) -> None:
    """Draw ``module``'s Parallel WaveGAN parameters from ``gen`` (a CPU
    generator) as the JAX modules' flax initializers do: every kernel
    lecun-normal over its fan-in (the kernel size times the input
    channels; the residual stack's layer axis is a batch axis), weight-norm
    scales one, biases zero."""
    for path, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if "kernel" in name:
                shape = p.shape[1:] if isinstance(mod, ResidualStack) \
                    else p.shape
                fan_in = math.prod(shape[:-1])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                value = torch.empty(p.shape, dtype=_F32)
                nn.init.trunc_normal_(value, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen)
                p.copy_(value)
            elif "scale" in name:
                p.fill_(1.0)
            elif "bias" in name:
                p.zero_()
            else:
                raise ValueError(f"no initializer for {path}.{name}")
