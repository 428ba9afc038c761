"""Int8 post-training quantization for serving (counterpart of
cvnets_tpu/quantization/__init__.py).

Two modes (``--common.int8-mode``), both turned on by
``--common.int8-inference`` and both for an eval forward only (a module in
training mode runs its float forward, as the JAX package's ``not training``
gate does):

* ``weight-only`` (default): int8 weights, dequantized into the compute
  dtype in front of the float product;
* ``dynamic``: s8 × s8 → s32 products (``torch._int_mm``) with per-row
  activation scales for a linear layer (absmax over the contraction dim of
  each token) and per-sample scales for a conv (a conv sums over H, W and C of
  one sample, never over the batch). A k×k conv is an ``unfold`` of the codes
  followed by the product; a 1×1 conv a product on the strided pixels.

Weights are per output channel symmetric int8 (``quantize_symmetric``): the
scale is ``max(absmax, 1e-12) · (1 / 127)`` in float32 and the codes
``round(w / scale)`` (half to even, as ``jnp.round``) clipped to ±127. The
JAX source writes ``/ 127.0``, but every JAX path runs it under ``jit``, where
XLA multiplies by the float32 reciprocal instead (one ulp apart on ~4% of the
channels); the port computes what the jitted JAX package computes, so its
codes and scales are the JAX package's bit for bit.

``Int8Conv`` and ``Int8Dense`` keep the float layer's parameter names
(``weight``, ``bias``), so a float checkpoint loads into an int8 model
unchanged; handed a float weight they quantize it at every call.
``prequantize(model)`` stores each such weight in int8 once, beside its
``weight_scale`` buffer, and frees the float one: what serving should run.
``int8_layers(model)`` names the int8 layers.

Only the layers the JAX package routes through ``quant_dense`` or
``Int8Conv`` take the int8 forward: ``ConvLayer2d``'s conv where groups == 1,
and the projections, FFNs and classifier heads built by ``quant_linear``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.linear_layer import LinearLayer

MODE_DYNAMIC = "dynamic"
MODE_WEIGHT_ONLY = "weight-only"
MODES = (MODE_DYNAMIC, MODE_WEIGHT_ONLY)
# torch._int_mm on a CUDA tensor takes more than 16 rows and a depth and a
# width that are multiples of 8; zero rows and columns pad a product exactly
_MIN_ROWS, _ALIGN = 17, 8


def int8_inference_enabled(opts) -> bool:
    return bool(getattr(opts, "common.int8_inference", False))


def int8_mode_of(opts) -> Optional[str]:
    """The int8 mode of ``opts``, or None without ``--common.int8-inference``."""
    if opts is None or not int8_inference_enabled(opts):
        return None
    mode = getattr(opts, "common.int8_mode", MODE_WEIGHT_ONLY) or MODE_WEIGHT_ONLY
    if mode not in MODES:
        raise ValueError(f"--common.int8-mode {mode!r}: one of {MODES}")
    return mode


def quantize_symmetric(w: torch.Tensor, dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of ``w`` and the float32 scales, reduced over
    ``dims`` (kept as size 1): ``w ≈ q.float() * scale``; a zero slice gets
    the scale 1e-12 / 127 and codes 0."""
    q, scale = _codes(w, dims)
    return q.to(torch.int8), scale


def _codes(x: torch.Tensor, dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_symmetric`` with the codes left in float32 (whole numbers,
    so an unfold or a gather of them is exact): of a weight, or of an
    activation at every call of a dynamic layer."""
    xf = x.float()
    absmax = xf.abs().amax(dim=tuple(dims), keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) * (1.0 / 127.0)
    return torch.clamp(torch.round(xf / scale), -127, 127), scale


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 codes times the (N, K) int8 weight's transpose, summed in
    int32 by ``torch._int_mm``. On a CUDA tensor the rows are padded past 16
    and the depth and the width to multiples of 8 with zeros (exact), and the
    result is cut back to (M, N)."""
    m, k = a.shape
    n = w.shape[0]
    if a.is_cuda:
        kp = -(-k // _ALIGN) * _ALIGN
        np_ = -(-n // _ALIGN) * _ALIGN
        a = _pad_to(_pad_to(a, 1, kp), 0, max(m, _MIN_ROWS))
        w = _pad_to(_pad_to(w, 1, kp), 0, np_)
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if out.shape != (m, n) else out


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the float layer would compute in: autocast's where it is on
    (``--common.mixed-precision``), else the input's."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


class _Int8Weight:
    """What ``Int8Conv`` and ``Int8Dense`` share: the mode, the reduction dims
    of the per-output-channel scale, the weight's codes and scale (stored, or
    quantized from the float weight at this call), and a count of the
    ``torch._int_mm`` products a dynamic forward ran."""

    mode: str
    scale_dims: Tuple[int, ...]
    int_mm_calls: int

    def qweight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.weight.dtype == torch.int8:
            return self.weight, self.weight_scale
        return quantize_symmetric(self.weight.detach(), self.scale_dims)

    def _check_float_weight(self) -> None:
        if self.weight.dtype == torch.int8:
            raise RuntimeError(f"{type(self).__name__}: a prequantized layer has no float "
                               "weight to train; build the model anew for training")

    @torch.no_grad()
    def prequantize(self) -> None:
        """Replace the float ``weight`` parameter by its int8 codes and add
        the ``weight_scale`` buffer; the float tensor is freed."""
        if self.weight.dtype == torch.int8:
            return
        q, scale = quantize_symmetric(self.weight, self.scale_dims)
        del self.weight
        self.register_buffer("weight", q)
        self.register_buffer("weight_scale", scale)

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, int8_mode={self.mode}"


class Int8Dense(_Int8Weight, LinearLayer):
    """A ``LinearLayer`` with an int8 eval forward (cvnets_tpu/quantization
    ``Int8Dense``): the parameters are the float layer's (``weight`` (out,
    in), ``bias``), the scale per output row."""

    scale_dims = (1,)

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_init: str = "linear", mode: str = MODE_WEIGHT_ONLY) -> None:
        super().__init__(in_features, out_features, bias=bias, weight_init=weight_init)
        self.mode, self.int_mm_calls = mode, 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self._check_float_weight()
            return super().forward(x)
        dt = _compute_dtype(x)
        qw, w_scale = self.qweight()
        with torch.autocast(x.device.type, enabled=False):
            if self.mode == MODE_WEIGHT_ONLY:
                w = qw.to(dt) * w_scale.to(dt)
                out = F.linear(x.to(dt), w).float()
            else:
                codes, x_scale = _codes(x, (-1,))
                lead = codes.shape[:-1]
                acc = int8_matmul(codes.reshape(-1, codes.shape[-1]).to(torch.int8), qw)
                self.int_mm_calls += 1
                out = acc.float().reshape(*lead, -1) * (x_scale * w_scale.reshape(-1))
            if self.bias is not None:
                out = out + self.bias.float()
        return out.to(dt)


class Int8Conv(_Int8Weight, nn.Conv2d):
    """An ``nn.Conv2d`` with an int8 eval forward (cvnets_tpu/quantization
    ``Int8Conv``): the parameters are the float conv's (``weight`` (O, I,
    kh, kw), ``bias``), the scale per output channel. Built only for a dense
    conv (groups == 1), as the JAX package swaps only those."""

    scale_dims = (1, 2, 3)

    def __init__(self, *args, mode: str = MODE_WEIGHT_ONLY, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if self.groups != 1:
            raise ValueError("Int8Conv: a grouped conv stays float (groups must be 1)")
        if self.padding_mode != "zeros" or isinstance(self.padding, str):
            raise ValueError("Int8Conv: explicit zero padding only")
        self.mode, self.int_mm_calls = mode, 0

    def _dynamic(self, x: torch.Tensor, qw: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
        codes, x_scale = _codes(x, (1, 2, 3))      # (N, C, H, W), (N, 1, 1, 1)
        n = x.shape[0]
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = (self.kernel_size, self.stride,
                                                  self.padding, self.dilation)
        if (kh, kw, ph, pw) == (1, 1, 0, 0):
            codes = codes[:, :, ::sh, ::sw]
            ho, wo = codes.shape[-2:]
            cols = codes.permute(0, 2, 3, 1).reshape(-1, codes.shape[1])
        else:
            ho = (x.shape[2] + 2 * ph - dh * (kh - 1) - 1) // sh + 1
            wo = (x.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
            cols = F.unfold(codes, (kh, kw), dilation=(dh, dw), padding=(ph, pw),
                            stride=(sh, sw))                  # (N, C·kh·kw, L)
            cols = cols.transpose(1, 2).reshape(n * ho * wo, -1)
        acc = int8_matmul(cols.to(torch.int8), qw.reshape(qw.shape[0], -1))
        self.int_mm_calls += 1
        # x_scale (N, 1, 1) times w_scale (1, 1, O), then the (N, L, O) sums
        out = acc.float().reshape(n, ho * wo, -1) * (x_scale.reshape(n, 1, 1)
                                                     * w_scale.reshape(1, 1, -1))
        if self.bias is not None:
            out = out + self.bias.float()
        return out.reshape(n, ho, wo, -1).permute(0, 3, 1, 2).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self._check_float_weight()
            return super().forward(x)
        dt = _compute_dtype(x)
        qw, w_scale = self.qweight()
        with torch.autocast(x.device.type, enabled=False):
            if self.mode == MODE_WEIGHT_ONLY:
                w = qw.to(dt) * w_scale.to(dt)
                out = self._conv_forward(x.to(dt), w, None).float()
                if self.bias is not None:
                    out = out + self.bias.float()[:, None, None]
            else:
                out = self._dynamic(x, qw, w_scale)
        return out.to(dt)


def quant_linear(opts, in_features: int, out_features: int, bias: bool = True,
                 weight_init: str = "linear") -> LinearLayer:
    """``LinearLayer``, or ``Int8Dense`` under ``--common.int8-inference``
    (the port's ``quant_dense``): the same parameters either way."""
    mode = int8_mode_of(opts)
    if mode is None:
        return LinearLayer(in_features, out_features, bias=bias, weight_init=weight_init)
    return Int8Dense(in_features, out_features, bias=bias, weight_init=weight_init, mode=mode)


def int8_layers(model: nn.Module) -> Dict[str, nn.Module]:
    """The model's ``Int8Conv`` and ``Int8Dense`` layers by module path."""
    return {name: m for name, m in model.named_modules() if isinstance(m, _Int8Weight)}


def prequantize(model: nn.Module) -> nn.Module:
    """Store every int8 layer's weight in int8 with its scale (the port's
    ``prequantize_variables``, cvnets_tpu/quantization:231-265), in place;
    returns ``model``. Its state dict then holds ``<layer>.weight`` int8 and
    ``<layer>.weight_scale`` float32 for each."""
    for layer in int8_layers(model).values():
        layer.prequantize()
    return model
