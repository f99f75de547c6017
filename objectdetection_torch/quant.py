"""Int8 post-training quantization of the serving path.

Port of ``objectdetection_tpu.quant``. Scheme (symmetric PTQ):

- activations: int8 with a scale calibrated as the absmax seen over
  calibration images (one scalar per tensor, or one per input channel with
  ``per_channel``), :func:`calibrate_variables`;
- weights: int8 per output channel (:func:`weight_qparams`), quantized from
  the float weights at call time, or once by :func:`freeze_weights`, after
  which the ``weight`` tensor holds the int8 values and ``kernel_scale`` the
  per-channel scale;
- compute: an exact int8 × int8 → int32 product, then the epilogue
  ``(f32(y32) · post).to(dtype) + bias``.

A conv's product and epilogue are one kernel on the card
(``ops/int8_conv.py``, :meth:`QuantConv.fused`), which can also take the
BatchNorm, residual, ReLU and requant that follow it. The dense product is
a library call, as the JAX package leaves it to XLA: ``torch._int_mm`` on
the card (padded to its shape rules, never replaced by a float product);
on the CPU both are f32 products over chunks of 1024 input channels (exact:
no partial sum of a chunk can reach 2^24; the chunks add in int32). The
JAX package's CPU path sums whole convs in f32, exact while the actual sums
stay below 2^24, as they do at the tests' sizes. The plain conv
(:func:`int8_conv`) is a matmul over pixels for a 1×1 conv (a stride-2 one
slices first); a k×k conv gathers k·k shifted int8 slices (im2col, (dy, dx,
ci)-major, the layout of an HWIO kernel, which the kernel's taps follow).

Layouts: float activations are NCHW tensors in channels_last memory, as
everywhere in the port; int8 activations are NHWC contiguous tensors, so the
im2col and the matmul read them in place. The scale of an int8 tensor is a
scalar or a [C] vector broadcast on its last axis, as in JAX. Weights keep
the port's layouts (conv OIHW, dense [out, in]).

Calibration is a mode: inside ``with calibration():`` every quantized module
runs the float forward and raises its recorded absmax in place, in the
tensors it was called with (flax's ``mutable=["quant"]``). Inside
``with recording_means(store):`` as well, every QuantConv and QuantDense
also leaves the per-channel mean of its input in ``store`` (flax's
``mutable=["stats"]`` and ``sow``), which :func:`record_act_means` collects
for the bias correction of :func:`apply_bias_correction`. Every division
below divides by a tensor on the operand's device: CUDA turns division by a
host scalar into multiplication by its reciprocal, which rounds differently
from the JAX reference.

Inference only: nothing here is differentiable.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# int8 symmetric range: [-128, 127] for activations, [-127, 127] for weights
ACT_QMAX = 127.0
W_QMAX = 127.0

# leaves of the flax ``quant`` collection: scales recorded by calibration, and
# the per-output-channel weight scale that freeze_weights fills
ACT_SCALES = ("act_scale", "out_scale", "c1_out_scale", "shared_scale",
              "pooled_box_scale", "pooled_mask_scale")
QUANT_LEAVES = ACT_SCALES + ("kernel_scale",)

_calibrating = False
_means: Optional[Dict] = None  # module -> input mean, while recording_means is active


@contextlib.contextmanager
def calibration() -> Iterator[None]:
    """Run the model's float forward and record activation ranges."""
    global _calibrating
    prev, _calibrating = _calibrating, True
    try:
        yield
    finally:
        _calibrating = prev


def calibrating() -> bool:
    return _calibrating


@contextlib.contextmanager
def recording_means(store: Dict) -> Iterator[Dict]:
    """While calibrating, also record each QuantConv / QuantDense input's
    per-channel mean into ``store`` (keyed by module; a module called more
    than once, as the RPN head is per level, keeps its last call's)."""
    global _means
    prev, _means = _means, store
    try:
        yield store
    finally:
        _means = prev


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _inv(scale: torch.Tensor) -> torch.Tensor:
    """where(s > 0, 1 / max(s, 1e-30), 0), in f32."""
    s = scale.to(torch.float32)
    return torch.where(s > 0, _c(1.0, s) / torch.clamp(s, min=1e-30), torch.zeros_like(s))


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric activation quantization to int8 (scale on the last axis)."""
    q = torch.round(x.to(torch.float32) * (_inv(scale) * ACT_QMAX))
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dequantize_act(x8: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_act` (up to rounding)."""
    s = scale.to(torch.float32)
    return (x8.to(torch.float32) * (s / _c(ACT_QMAX, s))).to(dtype)


def weight_qparams(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 quantization of a port-layout kernel (output
    axis first): (int8 kernel, f32 scale [out]) with kernel ≈ k8 · s_w."""
    k = kernel.to(torch.float32)
    absmax = k.abs().amax(dim=tuple(range(1, k.dim())))
    sw = torch.clamp(absmax, min=1e-30) / _c(W_QMAX, k)
    shape = (-1,) + (1,) * (k.dim() - 1)
    k8 = torch.clamp(torch.round(k / sw.view(shape)), -127.0, 127.0).to(torch.int8)
    return k8, sw


def _fold_in(kernel: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """kernel · factor along the input axis (axis 1 of OIHW and [out, in])."""
    shape = [1] * kernel.dim()
    shape[1] = -1
    return kernel * factor.view(shape)


# ---------------------------------------------------------------------------
# The integer product

_EXACT_K = 1024  # 1024 · 128 · 127 < 2^24


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] × int8 [K, N] → int32 [M, N].

    On the card ``torch._int_mm``, which needs M > 16 and K, N multiples of
    8, and whose cuBLASLt call refuses M not a multiple of 32 at K <= 64 on
    an H100 (CUBLAS_STATUS_NOT_SUPPORTED): the operands are zero-padded to M
    a multiple of 32 and K, N multiples of 8, and the result cut back. On
    the CPU f32 products over chunks of 1024 input channels, each exact.
    """
    m, k = a.shape
    n = b.shape[1]
    if a.device.type == "cuda":
        pad_m, pad_k, pad_n = max(32 - m, (-m) % 32), (-k) % 8, (-n) % 8
        if pad_m or pad_k:
            a = F.pad(a, (0, pad_k, 0, pad_m))
        if pad_k or pad_n:
            b = F.pad(b, (0, pad_n, 0, pad_k))
        out = torch._int_mm(a.contiguous(), b.contiguous())
        return out[:m, :n] if (pad_m or pad_n) else out
    if a.device.type != "cpu":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    # f32 sums of at most _EXACT_K products (|p| <= 128·127) stay below 2^24,
    # so each chunk is exact in any summation order; chunks add in int32
    out = torch.zeros((m, n), dtype=torch.int32)
    for k0 in range(0, k, _EXACT_K):
        part = a[:, k0:k0 + _EXACT_K].to(torch.float32) @ b[k0:k0 + _EXACT_K].to(torch.float32)
        out += part.to(torch.int32)
    return out


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_pads(padding, h: int, w: int, k: int, s: int) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of flax ``"SAME"``, an int, or ((t, b), (l, r))."""
    if padding is None or padding == "SAME":
        return (*_same_pads(h, k, s), *_same_pads(w, k, s))
    if isinstance(padding, int):
        return padding, padding, padding, padding
    (t, b), (l, r) = padding
    return t, b, l, r


def int8_conv(x8: torch.Tensor, k8: torch.Tensor, stride: int = 1,
              padding=None) -> torch.Tensor:
    """x8 NHWC int8 × k8 OIHW int8 → int32 NHWC, exactly."""
    bsz, h, w, cin = x8.shape
    cout, _, kh, kw = k8.shape
    t, bo, l, r = conv_pads(padding, h, w, kh, stride)
    ho = (h + t + bo - kh) // stride + 1
    wo = (w + l + r - kw) // stride + 1
    if (t, bo, l, r) != (0, 0, 0, 0):
        x8 = F.pad(x8, (0, 0, l, r, t, bo))
    if kh == kw == 1:
        cols = x8[:, ::stride, ::stride].reshape(-1, cin)
    else:
        taps = [x8[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
                for dy in range(kh) for dx in range(kw)]
        cols = torch.cat(taps, dim=-1).reshape(-1, kh * kw * cin)
    wmat = k8.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    return int8_matmul(cols, wmat).view(bsz, ho, wo, cout)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def quantize_nchw(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Float NCHW activations → int8 NHWC contiguous."""
    return quantize_act(nhwc(x), scale).contiguous()


def _record(buf: torch.Tensor, x: torch.Tensor, channel_dim: int, owner=None) -> None:
    """buf ← max(buf, absmax of x), per channel when buf is a vector; and,
    under :func:`recording_means`, the mean of x over every axis but the
    channel axis as ``owner``'s input mean."""
    a = x.to(torch.float32).abs()
    dims = tuple(d for d in range(x.dim()) if d != channel_dim % x.dim())
    upd = a.amax(dim=dims) if buf.dim() else a.amax()
    buf.copy_(torch.maximum(buf, upd))
    if owner is not None and _means is not None:
        _means[owner] = x.to(torch.float32).mean(dim=dims)


# ---------------------------------------------------------------------------
# Modules


class _QuantLayer(nn.Module):
    """What QuantConv and QuantDense share: ``weight`` (f32, or int8 once
    frozen), ``kernel_scale``, ``act_scale``, ``per_channel``."""

    def _qparams(self, scale: torch.Tensor):
        """(int8 kernel, s_w) for inputs of scale ``scale``: the frozen
        tensors, or the weight quantized here (per channel: the [Cin]
        dequant s/127 folded into it first, as freeze_weights folds)."""
        if self.weight.dtype == torch.int8:
            return self.weight, self.kernel_scale
        if self.per_channel:
            return weight_qparams(_fold_in(self.weight, scale / _c(ACT_QMAX, scale)))
        return weight_qparams(self.weight)

    def _post(self, scale: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
        """The f32 multiplier of the int32 product."""
        return sw if self.per_channel else scale / _c(ACT_QMAX, scale) * sw


class QuantConv(_QuantLayer):
    """Conv with an int8 serving path and a float calibration path.

    ``weight`` [out, in, k, k] (f32, or int8 once frozen), ``bias`` [out];
    buffers ``kernel_scale`` [out] (ones until frozen) and ``act_scale``
    (scalar, or [in] with ``per_channel``). ``int8_compute=False`` serves in
    the compute dtype with the dequantized int8 kernel (the bf16 stem and
    ``bf16_stages``). Padding: flax ``"SAME"`` by default, or explicit.
    ``sows_mean=False`` records no input mean for bias correction (the
    ResNet stem: JAX's ``Stage1Conv`` sows none).
    """

    sows_mean = True

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding=None,
                 per_channel: bool = False, int8_compute: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.register_buffer("kernel_scale", torch.ones(cout))
        self.register_buffer("act_scale", torch.zeros(cin) if per_channel else torch.zeros(()))
        self.stride = stride
        self.padding = padding
        self.per_channel = per_channel
        self.int8_compute = int8_compute
        self.dtype = dtype

    def _conv_float(self, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        t, b, l, r = conv_pads(self.padding, x.shape[2], x.shape[3], k.shape[-1], self.stride)
        if t == b and l == r:
            y = F.conv2d(x, k, stride=self.stride, padding=(t, l))
        else:
            y = F.conv2d(F.pad(x, (l, r, t, b)), k, stride=self.stride)
        return y + self.bias.to(x.dtype).view(1, -1, 1, 1)

    def forward(self, x: torch.Tensor, in_scale: Optional[torch.Tensor] = None,
                return_x8: bool = False):
        """x: float NCHW, or (with ``in_scale``) int8 NHWC quantized with that
        scale. Returns float NCHW in the compute dtype, plus ``(x8, scale)``
        of the int8 input with ``return_x8`` (int8 path only)."""
        dt = self.dtype
        if calibrating():
            if self.weight.dtype == torch.int8:
                raise RuntimeError("calibrate before quant.freeze_weights, not after")
            _record(self.act_scale, x, 1, owner=self if self.sows_mean else None)
            return self._conv_float(x.to(dt), self.weight.to(dt))
        if not self.int8_compute:
            if return_x8:
                raise ValueError("return_x8 needs the int8 path")
            act = self.act_scale
            k8, sw = self._qparams(act)
            k = k8.to(torch.float32) * sw.view(-1, 1, 1, 1)
            if self.per_channel:
                # the bf16 conv takes unquantized x: undo the act fold
                k = _fold_in(k, torch.where(act > 0, _c(ACT_QMAX, act) / torch.clamp(
                    act, min=1e-30), torch.zeros_like(act)))
            xf = nchw(dequantize_act(x, in_scale, dt)) if in_scale is not None else x
            return self._conv_float(xf.to(dt), k.to(dt))
        act = self.act_scale
        if in_scale is not None:
            x8, scale = x, in_scale
        else:
            x8, scale = quantize_nchw(x, act), act
        y = nchw(self.fused(x8, scale))
        return (y, (x8, scale)) if return_x8 else y

    def fused(self, x8: torch.Tensor, scale: torch.Tensor, **epilogue) -> torch.Tensor:
        """The int8 conv of ``x8`` (int8 NHWC, quantized with ``scale``) with
        its epilogue, NHWC: the bias in the compute dtype, then what
        ``epilogue`` asks of ``ops.int8_conv.int8_conv_fused`` (``bn``,
        ``residual``, ``relu``, ``out_scale``)."""
        from objectdetection_torch.ops import int8_conv as ic

        k8, sw = self._qparams(scale)
        return ic.int8_conv_fused(x8, k8, self._post(scale, sw), self.bias, self.stride,
                                  self.padding, dtype=self.dtype, **epilogue)


class QuantDense(_QuantLayer):
    """Dense layer with an int8 serving path (``weight`` [out, in])."""

    def __init__(self, cin: int, cout: int, per_channel: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.register_buffer("kernel_scale", torch.ones(cout))
        self.register_buffer("act_scale", torch.zeros(cin) if per_channel else torch.zeros(()))
        self.per_channel = per_channel
        self.dtype = dtype

    def forward(self, x: torch.Tensor, in_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [..., in]: float, or int8 quantized with ``in_scale``."""
        dt = self.dtype
        if calibrating():
            if self.weight.dtype == torch.int8:
                raise RuntimeError("calibrate before quant.freeze_weights, not after")
            _record(self.act_scale, x, -1, owner=self)
            return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)
        act = self.act_scale
        if in_scale is not None:
            x8, scale = x, in_scale
        else:
            x8, scale = quantize_act(x, act), act
        k8, sw = self._qparams(scale)
        lead = x8.shape[:-1]
        y32 = int8_matmul(x8.reshape(-1, x8.shape[-1]), k8.t())
        y = (y32.to(torch.float32) * self._post(scale, sw)).to(dt) + self.bias.to(dt)
        return y.view(*lead, -1)


# ---------------------------------------------------------------------------
# Freezing and calibration


def _modules_with(state: Mapping[str, torch.Tensor], leaf: str) -> Iterator[str]:
    """Key prefixes ("path." or "") of the modules holding ``leaf``."""
    for name in state:
        if name.rsplit(".", 1)[-1] == leaf:
            yield name[: -len(leaf)]


def freeze_weights(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Pre-quantize every quantized kernel to int8, offline.

    ``weight`` becomes its int8 values and ``kernel_scale`` the per-channel
    scale; a per-channel ``act_scale`` folds into the kernel first (act/127
    along the input axis). Call after :func:`calibrate_variables`.
    Idempotent. Returns a new state dict.
    """
    out = dict(state_dict)
    for mod in _modules_with(state_dict, "kernel_scale"):
        k = state_dict.get(f"{mod}weight")
        if k is None or k.dtype == torch.int8:
            continue
        act = state_dict.get(f"{mod}act_scale")
        if act is not None and act.dim() == 1:
            k = _fold_in(k.to(torch.float32), act.to(torch.float32) / _c(ACT_QMAX, act))
        k8, sw = weight_qparams(k)
        out[f"{mod}weight"] = k8
        out[f"{mod}kernel_scale"] = sw
    return out


def quant_keys(state_dict: Mapping[str, torch.Tensor]):
    return [k for k in state_dict if k.rsplit(".", 1)[-1] in QUANT_LEAVES]


def _float_pipeline(model, chunk, anchors, config) -> None:
    """The calibration forward: extract → proposals → box head → mask head
    on the top ``detection_post_nms_instances`` proposals."""
    from objectdetection_torch.layers.proposals import proposal_layer

    feats, _, probs, deltas = model.extract(chunk)
    props = proposal_layer(probs, deltas, anchors, config, training=False)
    model.classify_rois(feats, props)
    model.predict_masks(feats, props[:, : config.detection_post_nms_instances])


def _chunks(images: torch.Tensor, b: int) -> Iterator[torch.Tensor]:
    """Chunks of ``b`` images; a ragged tail is padded by repeating images
    (shapes stay fixed)."""
    for i in range(0, images.shape[0], b):
        chunk = images[i: i + b]
        if chunk.shape[0] != b:
            chunk = torch.cat([chunk, chunk[: b - chunk.shape[0]]], 0)
        yield chunk


def calibrate_variables(
    params: Mapping[str, torch.Tensor],
    images,
    config,
    batch_size: Optional[int] = None,
    percentile: Optional[float] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Record activation scales by running the float forward on ``images``.

    params: a state dict of a ``quantized_inference`` config (float
    weights) on ``device``; images [N, H, W, 3] molded, numpy or tensor.
    Runs the whole pipeline (extract → proposals → box head → mask head on
    the top ``detection_post_nms_instances`` proposals), in chunks of
    ``batch_size`` (a ragged last chunk is padded by repeating images).
    Without ``percentile`` the scales are a running max over chunks; with
    it, each chunk records its own absmax and each scale becomes that
    percentile (linear interpolation) of the per-chunk values, which needs
    at least 2 chunks. Only activation scales reset per chunk, never
    ``kernel_scale``. Returns a new state dict.
    """
    from torch.func import functional_call

    from objectdetection_torch import detector
    from objectdetection_torch.anchors import config_anchors
    from objectdetection_torch.convert import resolve_device

    if not config.quantized_inference:
        raise ValueError("calibrate_variables needs a quantized_inference config")
    dev = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    model = detector._bound_model(config)
    detector.check_state(params, config)
    anchors = torch.from_numpy(config_anchors(config)).to(dev)
    b = batch_size or images.shape[0]
    keys = quant_keys(params)

    def step(quant, chunk):
        state = {**params, **quant}
        with torch.no_grad(), calibration():
            functional_call(model, state, (_float_pipeline, chunk, anchors, config), strict=True)
        return quant

    # activation scales record in f32 whatever the state's dtype (JAX's
    # maximum of a bf16 scale and an f32 absmax is f32); kernel_scale passes
    # through as it is
    def fresh(k, zero):
        if k.endswith(".kernel_scale"):
            return params[k].clone()
        if zero:
            return torch.zeros_like(params[k], dtype=torch.float32)
        return params[k].to(torch.float32, copy=True)

    out = dict(params)
    if percentile is None:
        quant = {k: fresh(k, False) for k in keys}
        for chunk in _chunks(images, b):
            quant = step(quant, chunk)
        out.update(quant)
        return out
    per_chunk = []
    for chunk in _chunks(images, b):
        per_chunk.append(step({k: fresh(k, True) for k in keys}, chunk))
    if len(per_chunk) < 2:
        out.update(per_chunk[0])
        return out
    q = float(percentile) / 100.0
    for k in keys:
        stacked = torch.stack([c[k] for c in per_chunk]).to(torch.float32)
        out[k] = torch.quantile(stacked, q, dim=0, interpolation="linear")
    return out


# ---------------------------------------------------------------------------
# Bias correction


def record_act_means(
    params: Mapping[str, torch.Tensor],
    images,
    config,
    batch_size: Optional[int] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Per-input-channel means of every QuantConv / QuantDense input on the
    float forward, for :func:`apply_bias_correction`.

    Runs :func:`calibrate_variables`' pipeline in chunks of ``batch_size``
    (the ragged tail padded by repeating images) on the float state dict
    ``params`` of a ``quantized_inference`` config (after calibration,
    before freezing); ``params`` is not modified. Returns ``{"<module
    path>.act_mean": [C_in] f32}``, the mean of the chunks' means (the
    flax ``stats`` collection through ``convert.flax_to_state_dict``).
    """
    from torch.func import functional_call

    from objectdetection_torch import detector
    from objectdetection_torch.anchors import config_anchors
    from objectdetection_torch.convert import resolve_device

    if not config.quantized_inference:
        raise ValueError("record_act_means needs a quantized_inference config")
    dev = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    model = detector._bound_model(config)
    detector.check_state(params, config)
    anchors = torch.from_numpy(config_anchors(config)).to(dev)
    names = {m: n for n, m in model.named_modules()}
    keys = quant_keys(params)
    per_chunk = []
    for chunk in _chunks(images, batch_size or images.shape[0]):
        state = {**params, **{k: params[k].clone() for k in keys}}  # scales move, params stay
        with torch.no_grad(), calibration(), recording_means({}) as store:
            functional_call(model, state, (_float_pipeline, chunk, anchors, config), strict=True)
        per_chunk.append({f"{names[m]}.act_mean": v for m, v in store.items()})
    return {k: torch.stack([c[k] for c in per_chunk]).mean(0) for k in per_chunk[0]}


def apply_bias_correction(
    frozen: Mapping[str, torch.Tensor],
    calibrated: Mapping[str, torch.Tensor],
    means: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """Fold the expected weight-quantization error into the biases.

    PTQ bias correction (Nagel et al., "Data-Free Quantization", 2019): the
    int8 path realizes the kernel r = k8 · s_w, which differs from the
    calibrated float kernel (with the per-channel act fold, k · act/127) by
    Δ; its expected output offset Δ · E[x] (E[x8] = E[x] · 127/act per
    channel) is a constant per output channel, subtracted from the bias at
    no serving cost.

    frozen: the state dict after :func:`freeze_weights` (int8 kernels);
    calibrated: the same before freezing (float kernels, act scales);
    means: from :func:`record_act_means`. A module without an int8 kernel,
    a bias or a mean is left as it is. Returns a new state dict in which
    only biases changed.
    """
    out = dict(frozen)
    for mod in _modules_with(frozen, "kernel_scale"):
        k8, bias = frozen.get(f"{mod}weight"), frozen.get(f"{mod}bias")
        mean = means.get(f"{mod}act_mean")
        if k8 is None or k8.dtype != torch.int8 or bias is None or mean is None:
            continue
        kf = calibrated[f"{mod}weight"].to(torch.float32)
        sw = frozen[f"{mod}kernel_scale"].to(torch.float32)
        act = frozen[f"{mod}act_scale"].to(torch.float32)
        mean = mean.to(device=kf.device, dtype=torch.float32)
        if act.dim() == 1:  # per channel: the act fold is in the kernel, E[x] -> E[x8]
            k_eff = _fold_in(kf, act / _c(ACT_QMAX, act))
            m_in = mean * torch.where(act > 0, _c(ACT_QMAX, act) / torch.clamp(act, min=1e-30),
                                      torch.zeros_like(act))
        else:  # per tensor: r = k8 · s_w approximates k itself
            k_eff, m_in = kf, mean
        r = k8.to(torch.float32) * sw.view((-1,) + (1,) * (k8.dim() - 1))
        delta = (k_eff - r).reshape(k8.shape[0], k8.shape[1], -1).sum(-1)  # [out, in]
        out[f"{mod}bias"] = bias + (delta @ m_in).to(bias.dtype)
    return out
