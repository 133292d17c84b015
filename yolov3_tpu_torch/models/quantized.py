"""Post-training-quantized (int8) serving (port of
`yolov3_tpu/models/quantized.py`).

`QuantizedYoloV3` is the port's `YoloV3` (the same modules, the same
state_dict) with a serving forward that runs in one of three modes on one
code path:

- bf16    (no scales): the reference's math, the folded epilogue
          `leaky(conv + b) * mul + add` in f32; the wiring oracle;
- collect (inside `calibrate`): bf16 math while recording each conv
          input's absmax, or its |activation| histogram; with
          `train_mode` each BatchNorm normalises with the batch's own
          statistics (QAT's calibration), never moving the running ones;
- int8    (after `set_act_scales`): per-output-channel symmetric weight
          scales, per-tensor activation scales, int8 x int8 -> int32 convs
          with the dequant, bias, LeakyReLU and affine BatchNorm folded
          into the epilogue.

The int8 wiring is the reference's under `pointwise_pallas`,
`conv3_pallas` and `down_pallas`, every conv on a hand-written kernel (the
wrappers in `ops/kernels/`, which take their plain versions on the CPU),
plus the stem region of the reference's kernel set (below):

- stem1 (`Darknet53_0/ConvBlock_0`) stays bf16 (`DEFAULT_QUANT_SKIP`);
  `quant_skip` may name any conv block, which then runs the bf16 path;
  its neighbours neither emit s8 into it nor read s8 out of it, and a
  feature block or YoloBlock holding one runs its convs one by one (the
  reference's unfused route), as do the stem region's routes, which need
  all their blocks int8;
- each stride-2 block quantizes its bf16 input and emits the next feature
  block's s8 input (`down_conv_q`);
- a feature block runs s8 in, s8 out: each rep's 1x1 on `pointwise_q`,
  its 3x3 with the residual of the dequantized block input and the next
  rep's quantize on `conv3x3_q`; the last rep emits the bf16 block output;
- a YoloBlock's mid 1x1s (CB2, CB4) emit the next 3x3's s8 input, CB4 also
  the bf16 route; its other convs and the two FPN 1x1s are plain int8
  conv blocks: `pointwise_q` / `conv3x3_q` with a float output only. The
  concatenated input of a YoloBlock's CB0 is quantized half by half with
  its one scale into one s8 tensor;
- the detection heads and the decode stay in the compute dtype / f32.

The stem region (stem2 -> FeatureBlock_0 -> ConvBlock_2) follows the
reference's `_s2d_region`, and so only when `cfg.stem_space_to_depth`
(the default; the port computes it in the plain layout, where the lifted
convs are the plain ones). `kernels` is the reference's flag dict, None
meaning `default_serving_kernels(device)`: the reference's set on a CUDA
device, `{}` on the CPU, as JAX gates its set to the TPU. The flags that
change the wiring:
- `region_full` + `region_rawimg`: the region kernel (`s2d_region_q`)
  takes the z-scored image and runs stem1 itself, so stem1's output never
  reaches device memory (stem1 must stay bf16, as `DEFAULT_QUANT_SKIP`
  keeps it);
- otherwise `region_full`: the whole region is one launch on stem1's
  output, which the kernel quantizes with ConvBlock_1's scale as it loads
  it (the reference's `region_rawin`, which is therefore the same route);
- with either, `region_fast` gives the fast epilogue and
  `region_affine2` the two-affine one (`ops/quant.py::region_epi_affine2`,
  with the consumers' weights sign-flipped); `prepare()` builds the
  region's table for this one mode (and its stem1 rows for `rawimg`);
- otherwise stem2 emits FeatureBlock_0's s8 input, and `region_pallas`
  runs the rest as one launch (`s2d_tail_q`);
- otherwise FeatureBlock_0 runs on the 1x1 and 3x3 kernels, and with
  `exit_pallas` its 3x3 emits ConvBlock_2's s8 input for the exit kernel
  (`exit_conv_q`); otherwise ConvBlock_2 is a stride-2 block.
Each step needs its blocks int8 and the kernel's limits (H and W multiples
of 4 or 2, channels multiples of 16, its shared-memory plan) on every
device, so the CPU takes the route the card takes; where a step does not
fit, the next one runs. `head_matmul` runs each detection head as one
`torch.matmul` on [B*gh*gw, Ci] (the reference computes it with XLA, not
in a kernel). `region_pipe`, `region_pipe2`, `rep_requant` and
`rep_requant_final` are TPU scheduling or storage folds the reference
calls bit-identical; `head_pad` pads the heads' channels for the TPU's
lanes and decode slices the padding away again, the same numbers;
`region_rawin` is the port's `region_full` route; and
`pointwise_pallas`, `conv3_pallas` and `down_pallas` are always on here:
all nine are accepted and change nothing. Any other name is a KeyError.

Activation scales are keyed by the JAX block paths
(`Darknet53_0/FeatureBlock_1/ConvBlock_0`, `YoloBlock_2/ConvBlock_3`,
`utils/checkpoint.py::flax_module_path`), so a dict from either package's
`calibrate` serves both. Everything the forward needs beyond the
activations (s8 weights in the kernels' layout, the folded epilogue rows,
the scales' reciprocals) is derived once, on the CPU, by `prepare()`: at
construction, after `load_state_dict` and in `set_act_scales`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolov3_tpu_torch.config import NIST_YOLOV3, InferenceConfig, ModelConfig
from yolov3_tpu_torch.models.yolo import (ConvBlock, YoloV3, conv2d_same,
                                          upsample_2x)
from yolov3_tpu_torch.ops import quant
from yolov3_tpu_torch.ops.decode import decode_detections
from yolov3_tpu_torch.ops.kernels.conv3x3_q import conv3x3_block_q
from yolov3_tpu_torch.ops.kernels.down_conv_q import down_conv_block_q
from yolov3_tpu_torch.ops.kernels.exit_conv_q import exit_conv_block_q
from yolov3_tpu_torch.ops.kernels.pointwise_q import pointwise_conv_block_q
from yolov3_tpu_torch.ops.kernels.s2d_region_q import (plan_tile,
                                                       s2d_region_block_q)
from yolov3_tpu_torch.ops.kernels.s2d_tail_q import s2d_tail_block_q
from yolov3_tpu_torch.utils import tracing

F32 = torch.float32
BF16 = torch.bfloat16

# conv blocks that stay bf16 in the int8 path: stem1 (contraction 9 x 3)
DEFAULT_QUANT_SKIP: Tuple[str, ...] = ("Darknet53_0/ConvBlock_0",)

_D = "Darknet53_0"
STEM1, STEM2 = f"{_D}/ConvBlock_0", f"{_D}/ConvBlock_1"
FB0_PW, FB0_C3 = (f"{_D}/FeatureBlock_0/ConvBlock_0",
                  f"{_D}/FeatureBlock_0/ConvBlock_1")
EXIT, FB1_IN = f"{_D}/ConvBlock_2", f"{_D}/FeatureBlock_1/ConvBlock_0"

# the reference's kernel flags (yolov3_tpu/models/quantized.py::_Ctx)
WIRING_FLAGS = ("region_full", "region_fast", "region_affine2",
                "region_rawimg", "region_pallas", "exit_pallas",
                "head_matmul")
NO_OP_FLAGS = ("region_pipe", "region_pipe2", "rep_requant",
               "rep_requant_final", "pointwise_pallas", "conv3_pallas",
               "down_pallas", "region_rawin", "head_pad")


def default_serving_kernels(device) -> Dict[str, bool]:
    """The reference's int8 serving set (`default_serving_kernels`,
    quantized.py:1346-1374) on a CUDA device; `{}` on the CPU, as the
    reference returns `{}` off the TPU."""
    if torch.device(device).type == "cuda":
        return {"exit_pallas": True, "region_full": True,
                "region_fast": True, "rep_requant": True,
                "region_pipe": True}
    return {}


def check_kernels(kernels: Dict[str, bool]) -> Dict[str, bool]:
    """The flag dict, validated: KeyError for a name the reference does not
    have."""
    out = {}
    for name, on in kernels.items():
        if name not in WIRING_FLAGS + NO_OP_FLAGS:
            raise KeyError(f"unknown kernel flag {name}")
        out[name] = bool(on)
    return out


def _next_blocks(cfg: ModelConfig) -> Dict[str, Optional[str]]:
    """For each int8 conv block whose kernel emits the next conv's s8
    input, that conv's name (None: the block emits its float output)."""
    d = "Darknet53_0"
    reps = [1, 2, cfg.block_count, cfg.block_count, cfg.block_count // 2]
    nxt: Dict[str, Optional[str]] = {}
    for i, r in enumerate(reps):
        fb = f"{d}/FeatureBlock_{i}"
        nxt[f"{d}/ConvBlock_{i + 1}"] = f"{fb}/ConvBlock_0" if r else None
        for j in range(r):
            nxt[f"{fb}/ConvBlock_{2 * j}"] = f"{fb}/ConvBlock_{2 * j + 1}"
            nxt[f"{fb}/ConvBlock_{2 * j + 1}"] = (
                f"{fb}/ConvBlock_{2 * j + 2}" if j < r - 1 else None)
    for k in range(3):
        for i in (2, 4):
            nxt[f"YoloBlock_{k}/ConvBlock_{i}"] = (
                f"YoloBlock_{k}/ConvBlock_{i + 1}")
    return nxt


class QuantizedYoloV3(YoloV3):
    """NHWC image -> (fm @ stride 32, 16, 8) in the compute dtype, in the
    mode set by `act_scales` (None: bf16) or by `calibrate`."""

    def __init__(self, config: ModelConfig,
                 act_scales: Optional[Dict[str, float]] = None,
                 kernels: Optional[Dict[str, bool]] = None,
                 quant_skip: Tuple[str, ...] = DEFAULT_QUANT_SKIP):
        super().__init__(dataclasses.replace(config,
                                             use_pallas_pointwise=False))
        self.alpha = config.leaky_relu_alpha
        self.act_scales = act_scales
        self.quant_skip = frozenset(quant_skip)
        self.kernels = None if kernels is None else check_kernels(kernels)
        self._collect: Optional[dict] = None
        self._hist = False
        self._bn_batch = False
        self.register_load_state_dict_post_hook(lambda m, _: m.prepare())
        self.prepare()

    @property
    def int8(self) -> bool:
        return self.act_scales is not None and self._collect is None

    def conv_blocks(self) -> List[Tuple[str, ConvBlock]]:
        """(JAX block path, module) of every conv block."""
        from yolov3_tpu_torch.utils.checkpoint import flax_module_path
        return [(flax_module_path(n), m) for n, m in self.named_modules()
                if isinstance(m, ConvBlock)]

    def set_act_scales(self, act_scales: Optional[Dict[str, float]]) -> None:
        """Switch to int8 with these scales (None: back to bf16); raises
        KeyError for a conv block without a scale."""
        self.act_scales = act_scales
        self.prepare()

    @torch.no_grad()
    def prepare(self) -> None:
        """Derive every block's constants on the CPU and place them beside
        its parameters: the bf16 epilogue's (mul, add) and, in int8 mode,
        the s8 weights [taps, Co, Ci], the epi rows (b/dq, mul*dq, add),
        1/s_x, 1/s_next and the residual's scale."""
        cfg = self.config
        scales = self.act_scales
        nxt = _next_blocks(cfg)

        def f32(name):
            if name not in scales:
                raise KeyError(f"no activation scale calibrated for {name}")
            return float(np.float32(scales[name]))

        folded, stem1 = {}, None
        for name, blk in self.conv_blocks():
            dev = blk.conv.weight.device
            cpu = {k: v.detach().to("cpu", F32) for k, v in (
                ("w", blk.conv.weight), ("b", blk.conv.bias),
                ("g", blk.bn.weight), ("o", blk.bn.bias),
                ("m", blk.bn.running_mean), ("v", blk.bn.running_var))}
            mul, add = quant.bn_affine(cpu["g"], cpu["o"], cpu["m"], cpu["v"],
                                       cfg.bn_epsilon)
            blk.q_name = name
            blk.constant("q_mul", mul.to(dev))
            blk.constant("q_add", add.to(dev))
            blk.q_int8 = scales is not None and name not in self.quant_skip
            if name == STEM1 and not blk.q_int8:
                stem1 = (cpu["w"], (cpu["b"], mul, add))
            if not blk.q_int8:
                continue
            sx = f32(name)
            w_t, epi = quant.fold_conv_block(cpu["w"], cpu["b"], mul, add, sx)
            folded[name] = epi
            blk.constant("q_wt", w_t.to(dev))
            blk.constant("q_epi", epi.to(dev))
            blk.q_scale, blk.q_inv_in = sx, quant.reciprocal(sx)
            nb = nxt.get(name)
            if nb in self.quant_skip:  # a bf16 block takes no s8 input
                nb = None
            blk.q_emits_s8 = nb is not None
            blk.q_inv_next = quant.reciprocal(f32(nb)) if nb else 0.0
            blk.q_res_scale = 0.0
            cb0 = name.rsplit("/", 1)[0] + "/ConvBlock_0"
            if ("/FeatureBlock_" in name and int(name.rsplit("_", 1)[1]) % 2
                    and cb0 not in self.quant_skip):
                blk.q_res_scale = f32(cb0)
        self._prepare_region(folded, f32, stem1)

    def _prepare_region(self, folded: dict, f32, stem1) -> None:
        """The stem region kernels' epi tables (ops/quant.py), where their
        blocks run int8: the tail's, the exit's and, under `region_full`,
        the region's in the one epilogue mode that the model's flags (None:
        the card's default set) select, `region_mode` = (fast, affine2);
        with `region_affine2` the sign-flipped consumer weights; with
        `region_rawimg`, where stem1 stays bf16, the table with stem1's
        rows and stem1's weights [9, c1, ci] in the compute dtype. None
        where they do not apply."""
        dev = self.darknet.convs[2].conv.weight.device
        flags = (self.kernels if self.kernels is not None
                 else default_serving_kernels("cuda"))
        fast, affine2 = (flags.get("region_fast", False),
                         flags.get("region_affine2", False))
        self.region_mode = (fast, affine2)
        tables = dict.fromkeys((
            "q_region_epi", "q_region_epi_img", "q_tail_epi", "q_exit_epi",
            "q_w_s1", "q_affine2_w_pw", "q_affine2_w_fb0", "q_affine2_w_ex"))
        # every route past "blocks" runs FeatureBlock_0 on its kernels and
        # emits FeatureBlock_1's s8 input
        if (all(n in folded for n in (FB0_PW, FB0_C3, EXIT))
                and FB1_IN not in self.quant_skip):
            tables["q_exit_epi"] = quant.exit_epi(folded[EXIT], f32(FB1_IN))
            tail = (folded[FB0_PW], folded[FB0_C3], folded[EXIT],
                    *(f32(n) for n in (FB0_PW, FB0_C3, EXIT, FB1_IN)))
            tables["q_tail_epi"] = quant.tail_epi(*tail)
        if (tables["q_tail_epi"] is not None and STEM2 in folded
                and flags.get("region_full")):
            if affine2:
                epi, signs = quant.region_epi_affine2(
                    folded[STEM2], *tail, alpha=self.alpha)
                _, pw, c3, down2 = self._stem_kernels()
                for key, blk, sgn in (("q_affine2_w_pw", pw, signs[0]),
                                      ("q_affine2_w_fb0", c3, signs[1]),
                                      ("q_affine2_w_ex", down2, signs[2])):
                    tables[key] = quant.flip_inputs(blk.q_wt.cpu(), sgn)
            else:
                epi = quant.region_epi(folded[STEM2], *tail, fast=fast)
            tables["q_region_epi"] = epi
            if flags.get("region_rawimg") and stem1 is not None:
                w, rows = stem1  # w OIHW f32
                tables["q_w_s1"] = w.permute(2, 3, 0, 1).reshape(
                    9, w.shape[0], w.shape[1]).to(self.config.dtype)
                tables["q_region_epi_img"] = quant.with_stem1(
                    epi, rows, f32(STEM2), fast=fast)
        for key, t in tables.items():
            self.register_buffer(
                key, None if t is None else t.contiguous().to(dev),
                persistent=False)

    # --- one conv block, any mode ------------------------------------------

    def _record(self, name: str, *tensors: torch.Tensor) -> None:
        if self._hist:
            self._collect[name] = quant.abs_histogram(tensors)
        else:
            self._collect[name] = torch.stack(
                [t.to(F32).abs().max() for t in tensors]).max()

    def _epilogue(self, blk: ConvBlock, y: torch.Tensor) -> torch.Tensor:
        """bias -> LeakyReLU -> affine BN on an f32 conv output; inside
        `calibrate(train_mode=True)` the BN of the batch's own statistics
        (quantized.py:278-300), the running ones left as they are."""
        y = y + blk.conv.bias.to(F32)
        y = torch.where(y >= 0, y, self.alpha * y)
        if self._bn_batch:
            mean = y.mean((0, 1, 2))
            var = torch.square(y - mean).mean((0, 1, 2))
            mul = torch.rsqrt(var + self.config.bn_epsilon) * blk.bn.weight
            return (y * mul + (blk.bn.bias - mean * mul)).to(
                self.config.dtype)
        return (y * blk.q_mul + blk.q_add).to(self.config.dtype)

    def _dequantize(self, q: torch.Tensor, blk: ConvBlock) -> torch.Tensor:
        """The image of s8 codes at `blk`'s input scale, in the compute
        dtype (the residual of `_Ctx.block_input`)."""
        return (q.to(F32) * np.float32(blk.q_scale)).to(self.config.dtype)

    def _kernel_kw(self, blk: ConvBlock, **kw) -> dict:
        return dict(inv_in=blk.q_inv_in, inv_next=blk.q_inv_next,
                    alpha=self.alpha, **kw)

    def _conv_block(self, blk: ConvBlock, x: torch.Tensor) -> torch.Tensor:
        """Conv -> LeakyReLU -> affine BN, output in the compute dtype."""
        dtype = self.config.dtype
        if self._collect is not None:
            self._record(blk.q_name, x)
        if not (self.int8 and blk.q_int8):
            y = conv2d_same(x.to(dtype), blk.w, None, blk.stride).to(F32)
            return self._epilogue(blk, y)
        kw = self._kernel_kw(blk, emit_s8=False, out_dtype=dtype)
        if blk.conv.weight.shape[-1] == 1:
            return pointwise_conv_block_q(x, blk.q_wt, blk.q_epi, **kw)
        kernel = conv3x3_block_q if blk.stride == 1 else down_conv_block_q
        return kernel(x, blk.q_wt, blk.q_epi, cast_bf16=dtype == BF16, **kw)

    def _pw_block(self, blk: ConvBlock, x: torch.Tensor,
                  emit_bf16: bool = False):
        """int8 1x1 block emitting the next conv's s8 input (and the bf16
        block output with `emit_bf16`)."""
        return pointwise_conv_block_q(
            x, blk.q_wt, blk.q_epi,
            **self._kernel_kw(blk, out_dtype=BF16 if emit_bf16 else None))

    def _down_block(self, blk: ConvBlock, x: torch.Tensor) -> torch.Tensor:
        if not (self.int8 and blk.q_int8 and blk.q_emits_s8):
            return self._conv_block(blk, x)
        dtype = self.config.dtype
        return down_conv_block_q(x.to(dtype), blk.q_wt, blk.q_epi,
                                 cast_bf16=dtype == BF16,
                                 **self._kernel_kw(blk))

    def _conv_block_cat2(self, blk: ConvBlock, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
        """The 1x1 block of concat([a, b], -1); in bf16 mode as two convs
        over the split kernel, in int8 over both halves quantized with the
        block's one scale."""
        if self._collect is not None:
            self._record(blk.q_name, a, b)
        if self.int8 and blk.q_int8:
            q = torch.cat([quant.quantize_act(t, blk.q_inv_in)
                           for t in (a, b)], dim=-1)
            return self._conv_block(blk, q)
        dtype, ca = self.config.dtype, a.shape[-1]
        y = (conv2d_same(a.to(dtype), blk.w[:, :ca], None, 1).to(F32)
             + conv2d_same(b.to(dtype), blk.w[:, ca:], None, 1).to(F32))
        return self._epilogue(blk, y)

    # --- the network ---------------------------------------------------------

    def _feature_block(self, fb, x: torch.Tensor) -> torch.Tensor:
        convs = fb.convs
        reps = len(convs) // 2
        if reps == 0:
            return x
        if self.int8 and all(c.q_int8 for c in convs):
            conv_in = x
            if x.dtype != torch.int8:  # requantize the block input
                conv_in = quant.quantize_act(x, convs[0].q_inv_in)
            q = conv_in
            for r in range(reps):
                c3 = convs[2 * r + 1]
                last = r == reps - 1
                q = conv3x3_block_q(
                    self._pw_block(convs[2 * r], q), c3.q_wt, c3.q_epi,
                    cast_bf16=self.config.dtype == BF16, residual_q=conv_in,
                    **self._kernel_kw(c3, res_scale=c3.q_res_scale,
                                      emit_s8=not last,
                                      out_dtype=BF16 if last else None))
            return q
        # one conv at a time (quantized.py:585-611); in int8 mode the
        # residual adds the dequantized image of the s8 block input
        inputs = x
        if x.dtype != torch.int8 and self.int8 and convs[0].q_int8:
            x = quant.quantize_act(x, convs[0].q_inv_in)
        if x.dtype == torch.int8:
            inputs = self._dequantize(x, convs[0])
        for r in range(reps):
            y = self._conv_block(convs[2 * r], x)
            x = inputs + self._conv_block(convs[2 * r + 1], y)
        return x

    def _yolo_block(self, yb, x: torch.Tensor,
                    x2: Optional[torch.Tensor] = None):
        c = yb.convs
        start = 0
        if x2 is not None:
            x = self._conv_block_cat2(c[0], x, x2)
            start = 1
        if not (self.int8 and all(blk.q_int8 for blk in c[2:])):
            for blk in c[start:5]:
                x = self._conv_block(blk, x)
            return x, self._conv_block(c[5], x)
        for blk in c[start:2]:
            x = self._conv_block(blk, x)
        x = self._conv_block(c[3], self._pw_block(c[2], x))
        q, route = self._pw_block(c[4], x, emit_bf16=True)
        return route, self._conv_block(c[5], q)

    def _stem_kernels(self) -> Tuple[ConvBlock, ...]:
        d = self.darknet
        return (d.convs[1], *d.blocks[0].convs, d.convs[2])

    def region_route(self, h: int, w: int, kernels: Dict[str, bool]) -> str:
        """Which stem-region route the int8 forward takes for an image (and
        so a stem1 output) of h x w: "rawimg", "region", "tail", "exit" or
        "blocks"."""
        if not (self.int8 and self.config.stem_space_to_depth):
            return "blocks"
        down1, pw, c3, down2 = self._stem_kernels()
        c1, c = down1.conv.weight.shape[1], down1.conv.weight.shape[0]
        cm, co = pw.conv.weight.shape[0], down2.conv.weight.shape[0]
        if kernels.get("region_full") and h % 4 == 0 and w % 4 == 0:
            ci = self.darknet.convs[0].conv.weight.shape[1]
            if (kernels.get("region_rawimg")
                    and self.q_region_epi_img is not None
                    and plan_tile(c1, c, cm, co, ci=ci)):
                return "rawimg"
            if (self.q_region_epi is not None
                    and plan_tile(c1, c, cm, co, region=True)):
                return "region"
        h2, w2 = -(-h // 2), -(-w // 2)
        if (kernels.get("region_pallas") and self.q_tail_epi is not None
                and h2 % 2 == 0 and w2 % 2 == 0
                and plan_tile(0, c, cm, co, region=False)):
            return "tail"
        if (kernels.get("exit_pallas") and self.q_exit_epi is not None
                and c % 16 == 0 and co % 16 == 0):
            return "exit"
        return "blocks"

    def _stem_region(self, y: torch.Tensor, route: str) -> torch.Tensor:
        """stem1's output (the image itself on the "rawimg" route) ->
        FeatureBlock_1's input, the reference's `_s2d_region` in int8
        mode."""
        down1, pw, c3, down2 = self._stem_kernels()
        cast = self.config.dtype == BF16
        if route in ("rawimg", "region"):
            fast, affine2 = self.region_mode
            rawimg = route == "rawimg"
            tail = ((self.q_affine2_w_pw, self.q_affine2_w_fb0,
                     self.q_affine2_w_ex) if affine2
                    else (pw.q_wt, c3.q_wt, down2.q_wt))
            return s2d_region_block_q(
                y, down1.q_wt, *tail,
                self.q_region_epi_img if rawimg else self.q_region_epi,
                alpha=self.alpha, cast_bf16=cast, fast=fast, affine2=affine2,
                inv_in=None if rawimg else down1.q_inv_in,
                w_s1=self.q_w_s1 if rawimg else None)
        q2 = self._down_block(down1, y)
        if route == "blocks":
            return self._down_block(
                down2, self._feature_block(self.darknet.blocks[0], q2))
        if q2.dtype != torch.int8:  # stem2 stayed bf16
            q2 = quant.quantize_act(q2, pw.q_inv_in)
        if route == "tail":
            return s2d_tail_block_q(q2, pw.q_wt, c3.q_wt, down2.q_wt,
                                    self.q_tail_epi, alpha=self.alpha,
                                    cast_bf16=cast)
        q4 = conv3x3_block_q(
            self._pw_block(pw, q2), c3.q_wt, c3.q_epi, cast_bf16=cast,
            residual_q=q2, inv_in=c3.q_inv_in, inv_next=down2.q_inv_in,
            alpha=self.alpha, res_scale=c3.q_res_scale)
        return exit_conv_block_q(q4, down2.q_wt, self.q_exit_epi,
                                 alpha=self.alpha, cast_bf16=cast)

    def neck_outputs(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Backbone + FPN up to the heads: the three neck outputs,
        stride 32 first."""
        cfg = self.config
        d = self.darknet
        y = x.to(cfg.dtype)
        # the stem: stem1, stem2, FeatureBlock_0 and the down conv after it
        with tracing.span("yolo.stem"):
            if self.int8 and cfg.stem_space_to_depth:
                kernels = (self.kernels if self.kernels is not None
                           else default_serving_kernels(y.device))
                route = self.region_route(y.shape[1], y.shape[2], kernels)
                if route != "rawimg":  # otherwise stem1 runs in the region
                    y = self._conv_block(d.convs[0], y)
                y = self._stem_region(y, route)
            else:
                y = self._conv_block(d.convs[0], y)
                y = self._feature_block(d.blocks[0],
                                        self._down_block(d.convs[1], y))
                y = self._down_block(d.convs[2], y)
        routes = []
        with tracing.span("yolo.backbone"):
            y = self._feature_block(d.blocks[1], y)
            for down, block in zip(d.convs[3:], d.blocks[2:]):
                y = self._feature_block(block, self._down_block(down, y))
                routes.append(y)
        route_s8, route_s16, route_s32 = routes

        def up(t):
            return upsample_2x(t, cfg.upsample_channel_sum)

        with tracing.span("yolo.neck"):
            route, yb1 = self._yolo_block(self.yolo_blocks[0], route_s32)
            y = self._conv_block(self.necks[0], route)
            route, yb2 = self._yolo_block(self.yolo_blocks[1], up(y),
                                          route_s16)
            y = self._conv_block(self.necks[1], route)
            _, yb3 = self._yolo_block(self.yolo_blocks[2], up(y), route_s8)
        return [yb1, yb2, yb3]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        matmul = bool(self.kernels and self.kernels.get("head_matmul"))
        necks = self.neck_outputs(x)
        with tracing.span("yolo.heads"):
            return [self._head(head, h, matmul)
                    for head, h in zip(self.heads, necks)]

    @staticmethod
    def _head(head, h: torch.Tensor, matmul: bool) -> torch.Tensor:
        """A detection head (1x1 conv + bias in the compute dtype); with
        `matmul` (the reference's `head_matmul`) as one matmul on the
        flattened pixels [B*gh*gw, Ci] @ [Ci, Co]."""
        if not matmul:
            return head(h)
        n, gh, gw, ci = h.shape
        w = head.w.reshape(head.w.shape[0], ci)
        y = torch.matmul(h.to(head.dtype).reshape(n * gh * gw, ci), w.t())
        return (y + head.b).reshape(n, gh, gw, -1)

    def forward_detections(self, x: torch.Tensor) -> torch.Tensor:
        """Feature maps -> decoded detections [B, num_boxes, 4+1+C]."""
        cfg = self.config
        return decode_detections(self(x), cfg.anchors, cfg.number_classes,
                                 cfg.strides)


@torch.inference_mode()
def calibrate(model: QuantizedYoloV3, images: torch.Tensor,
              percentile: Optional[float] = None,
              train_mode: bool = False) -> Dict[str, float]:
    """Per-tensor activation scales {block path: scale} from one batch
    (z-scored NHWC f32), in the bf16 mode's math: absmax / 127, or with
    `percentile` (e.g. 99.9) that percentile of |activations| from a
    4096-bin histogram per conv input. `train_mode` (static QAT,
    quantized.py:1288-1322) normalises each BatchNorm with the batch's
    own statistics, as the train forward the scales serve does; the
    running statistics and every parameter stay untouched."""
    collect: dict = {}
    model._collect, model._hist = collect, percentile is not None
    model._bn_batch = train_mode
    try:
        model(images)
    finally:
        model._collect, model._hist, model._bn_batch = None, False, False
    if percentile is None:
        vals = {k: float(v) for k, v in collect.items()}
    else:
        vals = {k: float(quant.hist_percentile(c, m, percentile))
                for k, (c, m) in collect.items()}
    return {k: max(v, 1e-12) / 127.0 for k, v in vals.items()}


def scales_to_buffers(scales: Dict[str, float], model: YoloV3) -> None:
    """Set each static-QAT `act_scale` buffer of `model` from
    `calibrate`'s {block path: scale} dict (the counterpart of the
    reference's `scales_to_collection`, quantized.py:1325-1343). Raises
    KeyError when a declared scale has no value."""
    from yolov3_tpu_torch.utils.checkpoint import flax_module_path
    blocks = [(flax_module_path(n), m) for n, m in model.named_modules()
              if isinstance(m, ConvBlock) and hasattr(m, "act_scale")]
    for key, _ in blocks:
        if key not in scales:
            raise KeyError(f"no calibrated scale for {key}; have "
                           f"{sorted(scales)[:8]}...")
    with torch.no_grad():
        for key, m in blocks:
            m.act_scale.fill_(float(scales[key]))


def qat_recalibrator(cfg: ModelConfig, device):
    """Static QAT's scale refresh, recalibrate(model, images): `calibrate
    (train_mode=True)` of the training model's current weights on
    `images`, run by a `QuantizedYoloV3` mirror of them, written into
    its `act_scale` buffers (the JAX trainer's `recalibrate`,
    train.py:181-210)."""
    mirror = QuantizedYoloV3(cfg, kernels={}).to(device).eval()

    def recalibrate(model: YoloV3, images: torch.Tensor) -> None:
        mirror.load_state_dict(model.state_dict())
        scales_to_buffers(calibrate(mirror, images, train_mode=True), model)
    return recalibrate


def build_quantized_model(params: dict, batch_stats: dict, cfg: ModelConfig,
                          device,
                          act_scales: Optional[Dict[str, float]] = None,
                          kernels: Optional[Dict[str, bool]] = None,
                          quant_skip: Tuple[str, ...] = DEFAULT_QUANT_SKIP
                          ) -> QuantizedYoloV3:
    """`QuantizedYoloV3` with Flax-shaped weights, in eval mode on
    `device`; int8 when `act_scales` are given. `kernels`: the reference's
    kernel flags (None: `default_serving_kernels` of the device the
    forward runs on)."""
    from yolov3_tpu_torch.utils.checkpoint import params_from_jax
    if cfg.architecture != NIST_YOLOV3:
        raise ValueError(f"int8 serving is the NIST YOLOv3's alone, not "
                         f"{cfg.architecture}'s")
    model = QuantizedYoloV3(cfg, kernels=kernels, quant_skip=quant_skip)
    model.load_state_dict(params_from_jax(params, batch_stats, cfg))
    model = model.to(device).eval()
    if act_scales is not None:
        model.set_act_scales(act_scales)
    return model


def _calibrated(saved_model_filepath: str, calib_images,
                calib_percentile: Optional[float], device,
                kernels: Optional[Dict[str, bool]]):
    from yolov3_tpu_torch.utils import checkpoint as ckpt
    params, batch_stats, cfg = ckpt.load_model(saved_model_filepath)
    model = build_quantized_model(params, batch_stats, cfg, device,
                                  kernels=kernels)
    scales = calibrate(model, torch.as_tensor(calib_images, device=device),
                       calib_percentile)
    model.set_act_scales(scales)
    return model, cfg, scales


def make_quantized_detector_fn(saved_model_filepath: str, calib_images,
                               calib_percentile: Optional[float] = None,
                               device: str = "cuda",
                               kernels: Optional[Dict[str, bool]] = None,
                               devices: Optional[Sequence[str]] = None):
    """int8 twin of `inference.make_detector_fn`: detect(images NHWC f32)
    -> decoded detections [B, num_boxes, 4+1+C] (no NMS), calibrated on
    `calib_images` (a representative z-scored batch). `kernels`: kernel
    flag overrides (default: `default_serving_kernels(device)`). Over a
    `devices` list the scales calibrate once, on the first device, and
    the batch shards across replicas holding them
    (`distributed.shard_detector`)."""
    from yolov3_tpu_torch.parallel.distributed import shard_detector
    devices = [str(d) for d in devices] if devices else [device]
    model, cfg, scales = _calibrated(saved_model_filepath, calib_images,
                                     calib_percentile, devices[0], kernels)
    models = {devices[0]: model}
    for dev in devices[1:]:
        if dev not in models:
            from yolov3_tpu_torch.utils import checkpoint as ckpt
            params, batch_stats, _ = ckpt.load_model(saved_model_filepath)
            models[dev] = build_quantized_model(params, batch_stats, cfg,
                                                dev, act_scales=scales,
                                                kernels=kernels)

    def detector(dev):
        @torch.inference_mode()
        def detect(images) -> torch.Tensor:
            return models[dev].forward_detections(
                torch.as_tensor(images, device=dev))
        return detect

    if len(devices) == 1:
        return detector(devices[0]), cfg
    return shard_detector([detector(d) for d in devices], devices), cfg


def make_quantized_serving_fn(saved_model_filepath: str, calib_images,
                              icfg: Optional[InferenceConfig] = None,
                              min_box_size: Optional[int] = None,
                              calib_percentile: Optional[float] = None,
                              raw_pixels: bool = False,
                              device: str = "cuda",
                              kernels: Optional[Dict[str, bool]] = None):
    """int8 twin of `inference.make_serving_fn`: z-scored images ->
    (boxes, scores, keep) through the int8 backbone and neck, bf16 heads,
    f32 decode, clip, small-box filter and per-class NMS, all on `device`.
    With `raw_pixels`, serve() takes raw integer pixels and z-scores them
    first (calibration still takes a z-scored batch). `kernels`: kernel
    flag overrides (default: `default_serving_kernels(device)`).

    Returns (serve, cfg, scales)."""
    from yolov3_tpu_torch.data.device_pipeline import zscore_images
    from yolov3_tpu_torch.inference import serving_tail

    icfg = icfg or InferenceConfig()
    if min_box_size is None:
        min_box_size = icfg.min_box_size
    model, cfg, scales = _calibrated(saved_model_filepath, calib_images,
                                     calib_percentile, device, kernels)

    @torch.inference_mode()
    def serve(images):
        with tracing.span("yolo.serve"):
            images = torch.as_tensor(images, device=device)
            if raw_pixels:
                images = zscore_images(images).to(cfg.dtype)
            return serving_tail(model.forward_detections(images), images,
                                cfg.number_classes, icfg, min_box_size)

    return serve, cfg, scales


def decode_iou_fidelity(det_a: np.ndarray, det_b: np.ndarray,
                        top_k: int = 20) -> float:
    """Mean IoU between two paths' boxes at the top-K objectness slots of
    `det_a`: the quantized path's quality guard."""
    from yolov3_tpu_torch.ops.boxes import compute_iou
    ious = []
    for a, b in zip(np.asarray(det_a), np.asarray(det_b)):
        for i in np.argsort(-a[:, 4])[:top_k]:
            ious.append(float(compute_iou(a[i, 0:4], b[i:i + 1, 0:4])[0]))
    return float(np.mean(ious))

