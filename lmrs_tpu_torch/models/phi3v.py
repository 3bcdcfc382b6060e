"""Phi-3.5-vision image processor and projector (the "HD transform").

Counterpart of `lmrs_tpu/models/phi3v.py`.  The image operations run once
per image on the host in numpy (resize, pad, crop, normalize, patch
extraction); the 2x2 patch merge, the newline separators and the two-layer
projection MLP run on the features' device.

1. hd_transform: transpose a portrait image, find the largest scale whose
   crop count stays within hd_num, resize bilinearly to (scale * 336, .),
   pad the height to a multiple of 336 with white, transpose back.
2. A global 336x336 resize, and the 336x336 crops.
3. CLIP mean/std normalization; channel-planar 14x14 patch extraction.
4. The CLIP encoder (`models.vision`) over all crops at once.
5. reshape_hd_patches_2x2merge, the sub_GN newlines, [sub, glb_GN,
   global], then img_projection (GELU) into the text embedding space.

The bilinear resize is PIL's (`Image.resize(..., Image.BILINEAR)`, which
the JAX package calls) redone in numpy, bit for bit: the card's machine
has no PIL.  PIL is imported only to decode an image file.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple, Union

import numpy as np
import torch

from lmrs_tpu_torch.config import QuantType
from lmrs_tpu_torch.ops.activations import gelu_tanh
from lmrs_tpu_torch.ops.matmul import qmatmul_exact
from lmrs_tpu_torch.quant import QTensor

# CLIP normalization constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
CROP = 336

# the image turn's wrapping: these token rows go before and after the image
# embeddings (the first user turn after an image then ends with
# cli.chat.PHI_TURN_SUFFIX instead of the chat template)
PHI_IMAGE_PREFIX_IDS = [1, 32010, 29871, 13]
PHI_IMAGE_SUFFIX_IDS = [1, 29871, 13]


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    """The processor section's header (13 bytes in a `.lmrs` file)."""

    hidden_dim: int = 4096   # merged-channel width = 4 * CLIP dim
    text_dim: int = 3072
    quant: QuantType = QuantType.NONE
    group_size: int = 128


@dataclasses.dataclass
class ProcessorParams:
    glb_gn: torch.Tensor    # (hidden_dim,)
    sub_gn: torch.Tensor    # (hidden_dim,)
    proj0: QTensor          # (text_dim, hidden_dim)
    proj0_b: torch.Tensor   # (text_dim,)
    proj1: QTensor          # (text_dim, text_dim)
    proj1_b: torch.Tensor   # (text_dim,)


# ---------------------------------------------------------------------------
# Host-side image preprocessing (numpy)
# ---------------------------------------------------------------------------

_PRECISION_BITS = 22        # PIL's fixed point for 8-bit resampling


def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's resampling coefficients of the triangle filter over the whole
    input (`precompute_coeffs`, then `normalize_coeffs_8bpc`): the first
    input index of each output, and its fixed-point weights (out, ksize),
    0 past the input's end.  Every double operation is PIL's, in its
    order, so the weights come out bit for bit."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale           # the triangle's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    j = np.arange(ksize)
    arg = np.abs(((j[None] + xmin[:, None]).astype(np.float64)
                  - center[:, None] + 0.5) * ss)
    w = np.where((arg < 1.0) & (j[None] < xmax[:, None]), 1.0 - arg, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):                # PIL sums the weights in order
        ww = ww + w[:, i]
    # PIL divides only where ww != 0; where it is 0 every weight is 0
    w = w / np.where(ww == 0.0, 1.0, ww)[:, None]
    kk = np.trunc(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit separable resample along `axis`: an integer
    weighted sum plus a half, shifted down and clipped to uint8."""
    in_size = img.shape[axis]
    xmin, kk = _bilinear_coeffs(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    for i in range(kk.shape[1]):
        idx = np.minimum(xmin + i, in_size - 1)
        acc += (np.take(img, idx, axis=axis).astype(np.int64)
                * kk[:, i].reshape(shape))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8, equal to PIL's
    `Image.fromarray(img).resize((w, h), Image.BILINEAR)`: a horizontal
    pass, then a vertical one, each rounded to uint8; a pass whose size
    does not change is skipped."""
    out = np.asarray(img, np.uint8)
    if w != out.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != out.shape[0]:
        out = _resample_axis(out, h, 0)
    return np.array(out, copy=True)


def hd_transform(img: np.ndarray, hd_num: int) -> Tuple[np.ndarray, int, int]:
    """img (H, W, 3) uint8 -> (padded image, w_crop, h_crop)."""
    h, w = img.shape[:2]
    trans = w < h
    if trans:
        img = img.transpose(1, 0, 2)
        h, w = w, h

    ratio = w / h
    scale = 1.0
    while scale * np.ceil(scale / ratio) <= hd_num:
        scale += 1.0
    scale -= 1.0

    new_w = int(scale * CROP)
    new_h = int(new_w / ratio)
    img = resize_bilinear(img, new_w, new_h)

    # pad the height to a 336 multiple with white, split evenly
    tar = int(np.ceil(new_h / CROP) * CROP)
    top = (tar - new_h) // 2
    bot = tar - new_h - top
    img = np.pad(img, ((top, bot), (0, 0), (0, 0)), constant_values=255)
    new_h = tar

    if trans:
        img = img.transpose(1, 0, 2)
        new_w, new_h = new_h, new_w
    return img, new_w // CROP, new_h // CROP


def preprocess_image(img: np.ndarray, hd_num: int,
                     patch_size: int = 14) -> Tuple[np.ndarray, int, int, int]:
    """img (H, W, 3) uint8 -> (patches (num_crops + 1, 576, 3 * ps * ps)
    f32, w_crop, h_crop, num_crops + 1).  Crop 0 is the global 336x336
    view."""
    padded, w_crop, h_crop = hd_transform(img, hd_num)
    global_img = resize_bilinear(padded, CROP, CROP)

    tiles = padded.reshape(h_crop, CROP, w_crop, CROP, 3).transpose(
        0, 2, 1, 3, 4).reshape(-1, CROP, CROP, 3)
    crops = np.concatenate([global_img[None], tiles], axis=0)

    norm = (crops.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD

    # channel-planar patches: per patch all R values row-major, then G, B
    n = norm.shape[0]
    pps = CROP // patch_size
    p = norm.reshape(n, pps, patch_size, pps, patch_size, 3)
    p = p.transpose(0, 1, 3, 5, 2, 4)  # (n, py, px, c, y, x)
    patches = p.reshape(n, pps * pps, 3 * patch_size * patch_size)
    return patches.astype(np.float32), w_crop, h_crop, n


def load_image(source) -> np.ndarray:
    """An image file (a path or a binary file object) decoded to (H, W, 3)
    uint8 RGB.  Needs PIL; without it this raises (no other decoder)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding an image file needs PIL (Pillow); pass "
                          "an (H, W, 3) uint8 array instead") from e
    with Image.open(source) as im:
        return np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------------------
# Feature post-processing and projection (torch, on the features' device)
# ---------------------------------------------------------------------------

def reshape_hd_patches_2x2merge(features: torch.Tensor, h_crop: int,
                                w_crop: int) -> torch.Tensor:
    """(N, 576, C) -> (h_crop * 12, w_crop * 12, 4C): the crops laid out
    as a grid, each 2x2 block of patches merged into the channels in the
    order (0,0), (0,1), (1,0), (1,1).  N = h_crop * w_crop."""
    n, l, c = features.shape
    hh = int(math.isqrt(l))      # 24
    f = features.reshape(n, hh // 2, 2, hh // 2, 2, c)
    f = f.permute(0, 1, 3, 2, 4, 5).reshape(n, hh // 2, hh // 2, 4 * c)
    f = f.reshape(h_crop, w_crop, hh // 2, hh // 2, 4 * c)
    return f.permute(0, 2, 1, 3, 4).reshape(h_crop * hh // 2,
                                            w_crop * hh // 2, 4 * c)


def add_image_newline(grid: torch.Tensor, sub_gn: torch.Tensor
                      ) -> torch.Tensor:
    """Append the sub_GN separator to each row: (h, w, C) -> (h * (w+1),
    C)."""
    h, w, c = grid.shape
    sep = sub_gn.to(grid.dtype).expand(h, 1, c)
    return torch.cat([grid, sep], dim=1).reshape(h * (w + 1), c)


def processor_forward(params: ProcessorParams, cfg: ProcessorConfig,
                      features: torch.Tensor, w_crop: int,
                      h_crop: int) -> torch.Tensor:
    """CLIP features (num_crops + 1, 576, C) -> text embeddings (N,
    text_dim) f32; features[0] is the global crop."""
    glb = add_image_newline(reshape_hd_patches_2x2merge(features[:1], 1, 1),
                            params.sub_gn)
    sub = add_image_newline(
        reshape_hd_patches_2x2merge(features[1:], h_crop, w_crop),
        params.sub_gn)
    seq = torch.cat([sub, params.glb_gn[None].to(sub.dtype), glb], dim=0)
    hid = gelu_tanh(qmatmul_exact(seq, params.proj0) + params.proj0_b)
    return qmatmul_exact(hid, params.proj1) + params.proj1_b


# ---------------------------------------------------------------------------
# Image -> the embedding rows the text model prefills
# ---------------------------------------------------------------------------

def encode_image_to_embeds(vision, text_params, text_cfg,
                           image: Union[np.ndarray, str, os.PathLike],
                           num_crops: int, embed=None) -> torch.Tensor:
    """An image (an (H, W, 3) uint8 array, or a file that `load_image`
    decodes) -> the (N, D) f32 rows [image prefix, image, image suffix]
    for `Engine.prefill_embeds` or `BatchScheduler.prefill_embeds`, on the
    text parameters' device.  `vision` is the (VisionConfig, VisionParams,
    ProcessorConfig, ProcessorParams) of
    `io.params.vision_params_from_lmrs`.  `embed` maps (n,) token ids on
    the device to their (n, D) rows (default `embed_tokens` on the text
    parameters; a mesh's `Mesh.embed`, whose ranks each hold a block of
    the table)."""
    from lmrs_tpu_torch.models.transformer import embed_tokens
    from lmrs_tpu_torch.models.vision import vision_forward

    device = text_params.final_norm.device
    vcfg, vparams, pcfg, pparams = vision
    if not isinstance(image, np.ndarray):
        image = load_image(image)
    patches, w_crop, h_crop, _ = preprocess_image(image, num_crops,
                                                  vcfg.patch_size)
    with torch.no_grad():
        feats = vision_forward(vparams, vcfg,
                               torch.from_numpy(patches).to(device))
        img = processor_forward(pparams, pcfg, feats, w_crop, h_crop)

        def rows(ids):
            ids = torch.as_tensor(ids, dtype=torch.long, device=device)
            if embed is not None:
                return embed(ids).float()
            return embed_tokens(text_params, text_cfg, ids).float()

        return torch.cat([rows(PHI_IMAGE_PREFIX_IDS), img,
                          rows(PHI_IMAGE_SUFFIX_IDS)])
