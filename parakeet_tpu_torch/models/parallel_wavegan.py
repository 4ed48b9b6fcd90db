"""Parallel WaveGAN generator and discriminator (counterpart of
``parakeet_tpu/models/parallel_wavegan.py``).

The formulation follows the JAX package, not PyTorch's convolution
layers: dilated convolutions are shifted matmuls (``conv1d_taps``), the
upsampler is computed polyphase at frame rate, and weight norm is an
explicit (kernel, scale) pair.  Parameters therefore keep the flax
layouts ((k, Cin, Cout) kernels; the residual stack's stacked over layers
as (L, ...)), and ``bridge.load_flax_params`` copies them as they are.
Kernels start at zero: load or initialize weights before use.

The compute dtype is the modules' ``dtype`` when one is given (flax's
``dtype=``: mixed precision, float32 parameters and bf16 products), else
the parameters' dtype (``module.to(torch.bfloat16)``); weight norm is
always folded in float32.  Products take their operands in the compute
dtype and accumulate in float32, like ``jnp.dot(...,
preferred_element_type=float32)``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..nn.dropout import Dropout
from ..nn.precision import compute_dtype, mm_f32
from ..ops.geometry import time_shift as _shift
from ..ops.kernels.pwg_disc import (VJP_MODES, fused_disc_supported,
                                    fused_disc_tail)
from ..ops.kernels.pwg_stack import (fused_residual_stack,
                                     fused_stack_supported)
from ..ops.kernels.pwg_stack_train import fused_residual_stack_train
from ..utils.graphs import CapturedProgram

__all__ = ["PWGGenerator", "PWGDiscriminator", "ResidualPWGDiscriminator",
           "pwg_inference",
           "pwg_streaming_inference", "pwg_window_program",
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
    """a @ w with operands rounded to ``dtype`` and a float32 result: the
    float32-output bf16 GEMM on the card (``mm_f32``)."""
    return mm_f32(a.to(dtype), w.to(dtype))


def conv1d_taps(x: torch.Tensor, kernel: torch.Tensor, dilation: int = 1,
                padding: str = "SAME",
                dtype: torch.dtype = _F32) -> torch.Tensor:
    """Dilated 1-D conv as k shifted matmuls; x (B, T, Cin), kernel
    (k, Cin, Cout).  SAME is zero-padded and needs an odd k; VALID
    returns T - (k - 1) * dilation frames; CAUSAL pads on the left only
    (y[t] reads x[t - (k - 1 - j) * dilation]).  Accumulates in float32
    and returns ``dtype``."""
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
    elif padding == "CAUSAL":
        for j in range(k):
            y = _dot(_shift(x, (j - (k - 1)) * dilation), kernel[j], dtype)
            acc = y if acc is None else acc + y
    else:
        raise ValueError(f"unsupported padding {padding!r}")
    return acc.to(dtype)


class WNConv1d(nn.Module):
    """Weight-normalized dilated conv via shifted matmuls, (B, T, C)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 dilation: int = 1, padding: str = "SAME",
                 use_bias: bool = True, use_weight_norm: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dilation, self.padding, self.dtype = dilation, padding, dtype
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
        dt = compute_dtype(self.dtype, self.kernel)
        y = conv1d_taps(x, _wn(self.kernel, self.scale), self.dilation,
                        self.padding, dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def _phase_masks(scale: int, causal: bool = False) -> np.ndarray:
    """(3, 2*scale+1, scale) masks: masks[m, j, r] == 1 iff FIR tap j of
    output phase r reads input frame n + m - 1 (centered FIR) or n + m - 2
    (causal FIR, the reference's left-padded Conv2D) after
    nearest-stretch by ``scale``."""
    kt = 2 * scale + 1
    off = 2 * scale if causal else scale
    masks = np.zeros((3, kt, scale), np.float32)
    for r in range(scale):
        for j in range(kt):
            masks[(r + j - off) // scale + (2 if causal else 1), j, r] = 1.0
    return masks


def _activation(name: str):
    """The function a reference config names: a Paddle class name
    ('LeakyReLU', and 'PReLU' as a leaky ReLU, as the JAX package maps
    it) or a functional name of ``torch.nn.functional`` or ``torch``."""
    name = {"leakyrelu": "leaky_relu", "prelu": "leaky_relu"}.get(
        name.lower(), name.lower())
    fn = getattr(F, name, None) or getattr(torch, name, None)
    if fn is None:
        raise ValueError(f"unknown nonlinear_activation {name!r}")
    return fn


class UpsampleNet(nn.Module):
    """Nearest-stretch + (2s+1, kf) FIR per scale, computed polyphase at
    frame rate; mel (B, N, F) -> (B, N * prod(scales), F).  The FIR spans
    ``freq_axis_kernel_size`` (odd) mel channels; ``use_causal_conv``
    reads frames n-2..n instead of n-1..n+1; ``nonlinear_activation``
    (with its ``nonlinear_activation_params``) follows each scale's FIR.
    The phase masks are buffers, made once (not from numpy in every
    forward: a host copy that a CUDA graph capture refuses), and stay out
    of the state dict."""

    def __init__(self, upsample_scales: Sequence[int],
                 use_weight_norm: bool = True, freq_axis_kernel_size: int = 1,
                 nonlinear_activation: Optional[str] = None,
                 nonlinear_activation_params: Optional[dict] = None,
                 use_causal_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if freq_axis_kernel_size % 2 != 1:
            raise ValueError("freq_axis_kernel_size must be odd")
        self.upsample_scales = tuple(upsample_scales)
        self.use_weight_norm = use_weight_norm
        self.kf = freq_axis_kernel_size
        self.activation = (None if nonlinear_activation is None
                           else _activation(nonlinear_activation))
        self.activation_params = dict(nonlinear_activation_params or {})
        self.base = -2 if use_causal_conv else -1
        self.dtype = dtype
        for i, s in enumerate(self.upsample_scales):
            self.register_parameter(f"conv_{i}_kernel", nn.Parameter(
                torch.zeros(2 * s + 1, self.kf, 1, 1)))
            if use_weight_norm:
                self.register_parameter(f"conv_{i}_scale",
                                        nn.Parameter(torch.ones(1)))
            self.register_buffer(f"conv_{i}_masks", torch.from_numpy(
                _phase_masks(s, use_causal_conv)), persistent=False)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, getattr(self, "conv_0_kernel"))
        x = c.to(dt)
        for i, s in enumerate(self.upsample_scales):
            kernel = getattr(self, f"conv_{i}_kernel")[..., 0, 0]  # (kt, kf)
            if self.use_weight_norm:
                w = _wn(kernel.reshape(-1, 1), getattr(
                    self, f"conv_{i}_scale")).reshape(kernel.shape)
            else:
                w = kernel
            w = w.to(dt)
            masks = getattr(self, f"conv_{i}_masks").to(dt)
            b, n, f = x.shape
            shifted = [_shift(x, m + self.base) for m in range(3)]
            if self.kf == 1:
                # per-phase 3-tap comb as one (n, 3f) @ (3f, s*f) product
                km_all = torch.einsum("mjr,j->mr", masks, w[:, 0])  # (3, s)
                eye = torch.eye(f, dtype=dt, device=x.device)
                wmat = torch.einsum("mr,fg->mfrg", km_all, eye).reshape(
                    3 * f, s * f)
                x = _dot(torch.cat(shifted, dim=-1), wmat, dt).reshape(
                    b, n * s, f).to(dt)
            else:
                # each tap a product along the mel axis, in the compute
                # dtype (the JAX package's general branch)
                y = x.new_zeros((b, n, s, f))
                for m in range(3):
                    km = torch.einsum("jr,ji->ri", masks[m], w)  # (s, kf)
                    for fi in range(self.kf):
                        xs = _shift(shifted[m].transpose(1, 2),
                                    fi - self.kf // 2).transpose(1, 2)
                        y = y + xs[:, :, None, :] * km[None, None, :,
                                                       fi:fi + 1]
                x = y.reshape(b, n * s, f)
            if self.activation is not None:
                x = self.activation(x, **self.activation_params)
        return x


class ConvInUpsampleNet(nn.Module):
    """Context conv (VALID, no bias), then ``UpsampleNet``.  The mel must
    carry w = ``aux_context_window`` extra frames on both sides: the
    centered conv (k = 2w + 1) trims them; the causal one (k = w + 1, with
    ``use_causal_conv`` and w > 0) reads frames i..i+w and keeps the first
    T' - 2w outputs (reference parallel_wavegan.py:183-215)."""

    def __init__(self, upsample_scales: Sequence[int], aux_channels: int = 80,
                 aux_context_window: int = 2, use_weight_norm: bool = True,
                 freq_axis_kernel_size: int = 1,
                 nonlinear_activation: Optional[str] = None,
                 nonlinear_activation_params: Optional[dict] = None,
                 use_causal_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        w = aux_context_window
        self.window = w
        self.causal = use_causal_conv and w > 0
        self.conv_in = WNConv1d(aux_channels, aux_channels,
                                w + 1 if self.causal else 2 * w + 1,
                                padding="VALID", use_bias=False,
                                use_weight_norm=use_weight_norm, dtype=dtype)
        self.upsample = UpsampleNet(
            upsample_scales, use_weight_norm, freq_axis_kernel_size,
            nonlinear_activation, nonlinear_activation_params,
            use_causal_conv, dtype)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        n_out = c.shape[1] - 2 * self.window
        h = self.conv_in(c)
        return self.upsample(h[:, :n_out] if self.causal else h)


def stack_route(impl: str, supported: bool, on_cuda: bool,
                grad_needed: bool, dropout: float = 0.0,
                deterministic: Optional[bool] = None) -> str:
    """Which path ``ResidualStack`` takes: 'eager', 'k1' (the fused
    inference forward) or 'train' (the differentiable K2 groups).

    K1 writes its outputs from a kernel, outside autograd, so it runs only
    when no gradient is needed.  'fused' trains through K2 ('pallas' in
    the JAX package); 'auto' fuses only inference on CUDA, as the JAX
    'auto' fuses only deterministic calls.  Neither kernel drops out:
    under a live dropout (``deterministic`` False, by default when a
    gradient is needed, and a non-zero rate) 'auto' runs eager and
    'fused' raises, as the JAX 'pallas'.
    """
    if deterministic is None:
        deterministic = not grad_needed
    dropping = not deterministic and dropout != 0.0
    if impl == "eager":
        return "eager"
    if impl == "fused":
        if dropping:
            raise ValueError("impl='fused' training has no dropout path; use "
                             "impl='eager' (or 'auto') when dropout > 0")
        return "train" if grad_needed else "k1"
    if impl == "auto":
        return ("k1" if supported and on_cuda and not grad_needed
                and not dropping else "eager")
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
    otherwise).  A causal stack (``use_causal_conv``) or one without aux
    channels is never fused: 'auto' runs it eager and 'fused' raises.

    In training (``deterministic=False``) the eager loop drops each
    layer's conv input at rate ``dropout``, the keep-mask drawn from
    ``rng`` before the layer, and recomputes the layer in the backward
    (``torch.utils.checkpoint``, the JAX ``jax.checkpoint``) instead of
    keeping its gate activations.
    """

    def __init__(self, layers: int = 30, stacks: int = 3,
                 kernel_size: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 aux_channels: Optional[int] = 80, bias: bool = True,
                 use_weight_norm: bool = True, impl: str = "auto",
                 dropout: float = 0.0, use_causal_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if impl not in ("eager", "fused", "auto"):
            raise ValueError(f"unknown ResidualStack impl {impl!r}")
        self.layers, self.stacks, self.impl = layers, stacks, impl
        self.dropout = Dropout(dropout)
        self.padding = "CAUSAL" if use_causal_conv else "SAME"
        self.dtype = dtype
        self.residual_channels = residual_channels
        self.skip_channels = skip_channels
        self.supported = not use_causal_conv and fused_stack_supported(
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

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        dt = compute_dtype(self.dtype, self.conv_kernel)
        grad_needed = torch.is_grad_enabled() and (
            x.requires_grad or (c is not None and c.requires_grad)
            or any(p.requires_grad for p in self.parameters()))
        route = stack_route(self.impl, self.supported, x.is_cuda,
                            grad_needed, self.dropout.rate, deterministic)
        if route == "eager":
            return self._eager(x, c, dt, deterministic, rng, grad_needed)
        if c is None:
            raise ValueError("the fused residual stack needs c")
        if route == "k1":
            xf, skips = fused_residual_stack(
                x, c, self.fused_weights(), dilations=self.dilations(),
                stacks=self.stacks)
        else:
            # K2a/K2b take float32 x and c, as the JAX training route
            xf, skips = fused_residual_stack_train(
                x.float(), c.float(), self.fused_weights(),
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

    def _layer(self, xi, x, skips, c, i, d, dt):
        """One gated residual layer of the JAX package's 'xla' path, from
        its (dropped) conv input ``xi``: the conv output is rounded to the
        compute dtype before the biases are added."""
        half = self.conv_kernel.shape[-1] // 2

        def at(param):
            return None if param is None else param[i]

        g = conv1d_taps(xi, _wn(self.conv_kernel[i], at(self.conv_scale)),
                        d, self.padding, dt).to(_F32)
        if self.conv_bias is not None:
            g = g + self.conv_bias[i].to(_F32)
        if c is not None:
            g = g + _dot(c, _wn(self.aux_kernel[i], at(self.aux_scale)), dt)
        h = (torch.tanh(g[..., :half]) * torch.sigmoid(g[..., half:])).to(dt)
        s = _dot(h, _wn(self.skip_kernel[i], at(self.skip_scale)), dt)
        if self.skip_bias is not None:
            s = s + self.skip_bias[i].to(_F32)
        o = _dot(h, _wn(self.out_kernel[i], at(self.out_scale)), dt)
        if self.out_bias is not None:
            o = o + self.out_bias[i].to(_F32)
        return ((o + x.to(_F32)) * math.sqrt(0.5)).to(dt), skips + s

    def _eager(self, x, c, dt, deterministic, rng, grad_needed):
        skips = torch.zeros(x.shape[:2] + (self.skip_channels,),
                            dtype=_F32, device=x.device)
        x = x.to(dt)
        if c is None or self.aux_kernel is None:
            c = None
        recompute = grad_needed and not deterministic
        for i, d in enumerate(self.dilations()):
            xi = self.dropout(x, deterministic=deterministic, rng=rng)
            if recompute:
                x, skips = checkpoint(self._layer, xi, x, skips, c, i, d, dt,
                                      use_reentrant=False)
            else:
                x, skips = self._layer(xi, x, skips, c, i, d, dt)
        return x, skips


class PWGGenerator(nn.Module):
    """noise (B, T, 1) + mel (B, T', aux) -> waveform (B, T, 1), with
    T = (T' - 2 * aux_context_window) * prod(upsample_scales).  The
    fields are the JAX module's but ``interpolate_mode`` (only its
    'nearest' exists); ``dtype`` is the compute dtype."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 30, stacks: int = 3,
                 residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, aux_channels: int = 80,
                 aux_context_window: int = 2, dropout: float = 0.0,
                 bias: bool = True, use_weight_norm: bool = True,
                 use_causal_conv: bool = False,
                 upsample_scales: Sequence[int] = (4, 4, 4, 4),
                 freq_axis_kernel_size: int = 1,
                 nonlinear_activation: Optional[str] = None,
                 nonlinear_activation_params: Optional[dict] = None,
                 dtype: Optional[torch.dtype] = None,
                 stack_impl: str = "auto"):
        super().__init__()
        self.layers = layers
        self.aux_context_window = aux_context_window
        self.upsample_scales = tuple(upsample_scales)
        self.dtype = dtype
        self.upsample_net = ConvInUpsampleNet(
            self.upsample_scales, aux_channels, aux_context_window,
            use_weight_norm, freq_axis_kernel_size, nonlinear_activation,
            nonlinear_activation_params, use_causal_conv, dtype)
        self.first_conv = WNConv1d(in_channels, residual_channels, 1,
                                   use_weight_norm=use_weight_norm,
                                   dtype=dtype)
        self.stack = ResidualStack(
            layers, stacks, kernel_size, residual_channels, gate_channels,
            skip_channels, aux_channels, bias, use_weight_norm, stack_impl,
            dropout, use_causal_conv, dtype)
        self.last_conv_0 = WNConv1d(skip_channels, skip_channels, 1,
                                    use_weight_norm=use_weight_norm,
                                    dtype=dtype)
        self.last_conv_1 = WNConv1d(skip_channels, out_channels, 1,
                                    use_weight_norm=use_weight_norm,
                                    dtype=dtype)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def forward(self, x: torch.Tensor, c: torch.Tensor, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``deterministic=False`` is the training forward: the stack's
        dropout draws from ``rng``."""
        dt = compute_dtype(self.dtype, self.first_conv.kernel)
        c = self.upsample_net(c)
        x = self.first_conv(x)
        x, skips = self.stack(x, c, deterministic=deterministic, rng=rng)
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


def _pwg_receptive_frames(generator: PWGGenerator) -> int:
    """Mel-frame context that fully covers the generator's one-sided
    receptive field: the dilated residual stack (sum of dilations x
    (k-1)/2 samples a side) plus the polyphase upsampler's few frames of
    time taps."""
    stack = generator.stack
    per = stack.layers // stack.stacks
    kernel_size = stack.conv_kernel.shape[1]
    rf_samples = (stack.stacks * sum(2 ** i for i in range(per))
                  * ((kernel_size - 1) // 2))
    return -(-rf_samples // generator.upsample_factor) + 4


def _window_shape(generator: PWGGenerator, chunk_frames: int,
                  context_frames: Optional[int]) -> Tuple[int, int]:
    """(context frames c, window frames chunk_frames + 2c) of
    :func:`pwg_streaming_inference`."""
    c = (_pwg_receptive_frames(generator) if context_frames is None
         else context_frames)
    return c, chunk_frames + 2 * c


def pwg_window_program(generator: PWGGenerator, mel: torch.Tensor,
                       noise: Optional[torch.Tensor] = None, *,
                       chunk_frames: int = 256,
                       context_frames: Optional[int] = None
                       ) -> CapturedProgram:
    """One CUDA graph of ``generator`` (no autograd) at the window shape
    that :func:`pwg_streaming_inference` vocodes with these
    ``chunk_frames`` and ``context_frames``, for utterances of ``mel``'s
    batch, channels, type and device (and ``noise``'s type: float32
    without one).  Capture runs the window twice eagerly first, so it
    costs about three windows' time: make it once, before the first
    utterance, and pass it to every call as ``program``.  The graph holds
    the generator's parameters by address: moving or replacing them
    needs a new program."""
    squeeze = mel.ndim == 2
    b, _, f = (1, *mel.shape) if squeeze else mel.shape
    _, win_inner = _window_shape(generator, chunk_frames, context_frames)
    w, hop = generator.aux_context_window, generator.upsample_factor
    return CapturedProgram(
        lambda mel, noise: generator(noise, mel)[..., 0],
        {"mel": mel.new_empty((b, win_inner + 2 * w, f)),
         "noise": torch.empty((b, win_inner * hop, 1), device=mel.device,
                              dtype=torch.float32 if noise is None
                              else noise.dtype)})


def pwg_streaming_inference(generator: PWGGenerator, mel: torch.Tensor,
                            noise: Optional[torch.Tensor] = None,
                            rng: Optional[torch.Generator] = None, *,
                            chunk_frames: int = 256,
                            context_frames: Optional[int] = None,
                            program: Optional[CapturedProgram] = None
                            ) -> torch.Tensor:
    """Chunked mel -> waveform, equal to :func:`pwg_inference` on the whole
    utterance (the JAX package's ``pwg_streaming_inference``).

    The mel is edge-padded once, then vocoded in clamped windows of
    ``chunk_frames + 2 * context_frames`` frames that all lie inside the
    signal: an edge window's boundary is the signal's, so the convs' SAME
    zero padding there matches the whole-utterance run, and an interior
    window keeps only its centre, ``context_frames`` (by default
    ``_pwg_receptive_frames``) from either edge.  An utterance no longer
    than one window is vocoded in one shot.  Every window has one shape:
    with ``program`` (from :func:`pwg_window_program` at the same
    arguments, owned by the caller) each window is copied into its inputs
    and replayed, the counterpart of JAX's one program per window shape;
    without one each window runs eagerly.
    """
    squeeze = mel.ndim == 2
    if squeeze:
        mel = mel[None]
    b, t_mel, _ = mel.shape
    w = generator.aux_context_window
    hop = generator.upsample_factor
    c, win_inner = _window_shape(generator, chunk_frames, context_frames)
    mel_pad = edge_pad(mel, w)
    if noise is None:
        noise = torch.randn((b, t_mel * hop, 1), generator=rng,
                            device=mel.device)
    if t_mel <= win_inner:
        wav = generator(noise, mel_pad)[..., 0]
        return wav[0] if squeeze else wav
    if program is not None:
        shapes = {k: tuple(v.shape) for k, v in program.inputs.items()}
        want = {"mel": (b, win_inner + 2 * w, mel.shape[2]),
                "noise": (b, win_inner * hop, 1)}
        if shapes != want:
            raise ValueError(f"program's window inputs {shapes}, these "
                             f"arguments' windows {want}")
    wav = None
    for s in range(0, t_mel, chunk_frames):
        keep = min(chunk_frames, t_mel - s)
        w0 = min(max(s - c, 0), t_mel - win_inner)
        mel_win = mel_pad[:, w0:w0 + win_inner + 2 * w]
        noise_win = noise[:, w0 * hop:(w0 + win_inner) * hop]
        if program is not None:
            program.inputs["mel"].copy_(mel_win)
            program.inputs["noise"].copy_(noise_win)
            wav_win = program()
        else:
            wav_win = generator(noise_win, mel_win)[..., 0]
        if wav is None:
            wav = wav_win.new_empty((b, t_mel * hop))
        off = (s - w0) * hop
        wav[:, s * hop:(s + keep) * hop] = wav_win[:, off:off + keep * hop]
    return wav[0] if squeeze else wav


# the compute dtypes at which the discriminator's 'auto' fuses layers 1..9
# (K3a/K3b) on the card: both, as measured on one H100 (PERF.md:
# the discriminator's update at bf16, B=8, T=25,500, took 13.6-15.9 ms
# with K3a/K3b against 30.8-41.9 ms eager); the JAX package's TPU policy
# runs eager at bf16
FUSED_AUTO_DTYPES = (_F32, torch.bfloat16)


class PWGDiscriminator(nn.Module):
    """Stack of dilated convs + LeakyReLU; (B, T, 1) -> (B, T, 1) logits.

    Submodules carry the flax names (``conv_0`` .. ``conv_{layers-2}``,
    ``conv_last``), so ``bridge.load_flax_params`` loads the JAX tree.
    ``impl``: 'eager' (per-layer shifted matmuls in the compute dtype,
    the JAX package's 'xla'), 'fused' (layer 0 in PyTorch, layers 1..9
    through ``ops/kernels/pwg_disc.py`` on float32 input: kernels K3a/K3b
    on CUDA tensors, their plain versions on CPU tensors) or 'auto' (fused
    on CUDA tensors when the configuration is supported and the compute
    dtype is one of ``FUSED_AUTO_DTYPES``, eager otherwise).
    ``vjp_mode`` picks the fused route's backward, as the JAX field:
    'save' (K3a saves every layer's input, K3b reads them) or 'recompute'
    (K3a saves nothing, K3c rebuilds the inputs from the layer-0 output).
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 10,
                 conv_channels: int = 64, dilation_factor: int = 1,
                 negative_slope: float = 0.2, bias: bool = True,
                 use_weight_norm: bool = True, impl: str = "eager",
                 vjp_mode: str = "save",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if impl not in ("eager", "fused", "auto"):
            raise ValueError(f"unknown PWGDiscriminator impl {impl!r}")
        self.dtype = dtype
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
                use_weight_norm=use_weight_norm, dtype=dtype))
            cin = conv_channels
        self.conv_last = WNConv1d(cin, out_channels, kernel_size, 1,
                                  use_bias=bias,
                                  use_weight_norm=use_weight_norm,
                                  dtype=dtype)

    def convs(self):
        return [getattr(self, f"conv_{i}") for i in range(self.layers - 1)] + [
            self.conv_last]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        slope = self.negative_slope
        convs = self.convs()
        dt = compute_dtype(self.dtype, convs[0].kernel)
        fused = self.impl == "fused" or (
            self.impl == "auto" and self.supported and x.is_cuda
            and dt in FUSED_AUTO_DTYPES)
        if fused:
            h = F.leaky_relu(convs[0](x), slope).float()
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


class ResidualPWGDiscriminator(nn.Module):
    """WaveNet-style discriminator (no aux conditioning): first conv,
    LeakyReLU, an eager ``ResidualStack`` without aux channels, the
    sqrt(1 / L) skip scale, then two 1x1 convs, each after a LeakyReLU.
    (B, T, 1) -> (B, T, 1) logits."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 30, stacks: int = 3,
                 residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, dropout: float = 0.0,
                 bias: bool = True, use_weight_norm: bool = True,
                 negative_slope: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers, self.negative_slope, self.dtype = (layers,
                                                        negative_slope, dtype)
        self.first_conv = WNConv1d(in_channels, residual_channels, 1,
                                   use_weight_norm=use_weight_norm,
                                   dtype=dtype)
        self.stack = ResidualStack(
            layers, stacks, kernel_size, residual_channels, gate_channels,
            skip_channels, None, bias, use_weight_norm, "eager", dropout,
            dtype=dtype)
        self.last_conv_0 = WNConv1d(skip_channels, skip_channels, 1,
                                    use_weight_norm=use_weight_norm,
                                    dtype=dtype)
        self.last_conv_1 = WNConv1d(skip_channels, out_channels, 1,
                                    use_weight_norm=use_weight_norm,
                                    dtype=dtype)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        slope = self.negative_slope
        dt = compute_dtype(self.dtype, self.first_conv.kernel)
        h = F.leaky_relu(self.first_conv(x), slope)
        _, skips = self.stack(h, None, deterministic=deterministic, rng=rng)
        skips = skips * math.sqrt(1.0 / self.layers)
        h = F.leaky_relu(skips.to(dt), slope)
        h = F.leaky_relu(self.last_conv_0(h), slope)
        return self.last_conv_1(h)


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
