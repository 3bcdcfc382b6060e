"""Phi-3.5-vision, plain PyTorch and NumPy: the image processor, the CLIP
ViT-L/14-336 tower, the projector, and the Phi-3 text decoder of
`phi3.py` over the image's rows and the text.

After the published description (Hugging Face `image_processing_phi3_v.py`
and `modeling_phi3_v.py`, `CLIPVisionModel`), with the departures of the
lm.rs definition the system under test implements, each named:
- HD transform: a portrait image transposed, the largest scale whose crop
  count stays within `num_crops`, a bilinear resize to (scale * 336, .),
  the height padded with white to a multiple of 336 (split evenly), then
  transposed back; the 336 x 336 crops row by row.  The resize is PIL's
  BILINEAR 8-bit resampling (its fixed-point coefficients, a horizontal
  pass then a vertical one), written out here in NumPy.  Departure: the
  global view is that same bilinear resize of the padded image to 336 x
  336, where the published processor takes a bicubic interpolation of
  the normalized tensor.
- CLIP: patch convolution (no bias; stride = kernel, so each patch's
  values against the kernel), class embedding, positions,
  pre-layer-norm, then the first n_layers - 1 encoder layers (the
  penultimate hidden states, as Phi-3-V takes them), CLS dropped; queries
  scaled by 1/sqrt(head_dim) after their bias; QuickGELU.
- Every weight product of the tower and the projector is lm.rs's integer
  arithmetic, the configuration's W8A8: activations rounded per weight
  group to int8 at absmax / 127 (half away from zero), an integer dot per
  group, scaled by both groups' scales, the groups added in increasing
  order.
- Projector: the 2 x 2 patch merge, a `sub_GN` row separator after each
  row, [sub-image rows, `glb_GN`, global rows], Linear, GELU, Linear.
  Departure: the GELU is the tanh form (lm.rs), where the published model
  takes the erf form.
- The image's rows are the text embedding of the image prefix ids
  [1, 32010, 29871, 13], the projector's rows, then the suffix ids
  [1, 29871, 13].
Attention and layer norms are float32 with TF32 off.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from portbench.reference.phi3 import Phi3, control_gaps, served_gaps  # noqa

PREFIX_IDS = [1, 32010, 29871, 13]
SUFFIX_IDS = [1, 29871, 13]
CROP = 336
BITS = 22                       # PIL's fixed point for 8-bit resampling


def image_pixels(spec: Tuple[int, int, int]) -> np.ndarray:
    """The (H, W, 3) uint8 pixels the benchmark sends for (H, W, seed)."""
    h, w, seed = spec
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


# -- PIL's BILINEAR resampling (Imaging/Resample.c) ------------------------
def _coeffs(in_size: int, out_size: int):
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 1.0 * fscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / fscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = np.zeros(ksize)
        ww = 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            k[x] = 1.0 - t if t < 1.0 else 0.0
            ww += k[x]
        if ww != 0.0:
            k[:xmax] = k[:xmax] / ww
        xmins[xx] = xmin
        kk[xx] = np.where(k < 0, np.trunc(-0.5 + k * (1 << BITS)),
                          np.trunc(0.5 + k * (1 << BITS))).astype(np.int64)
    return xmins, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    n = img.shape[axis]
    xmins, kk = _coeffs(n, out_size)
    a = np.moveaxis(img.astype(np.int64), axis, 0)
    acc = np.full((out_size,) + a.shape[1:], 1 << (BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        src = np.minimum(xmins + j, n - 1)
        acc += a[src] * kk[:, j].reshape((-1,) + (1,) * (a.ndim - 1))
    out = np.clip(acc >> BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8 as PIL resizes it."""
    out = img
    if w != out.shape[1]:
        out = _pass(out, w, 1)
    if h != out.shape[0]:
        out = _pass(out, h, 0)
    return out


def hd_crops(img: np.ndarray, num_crops: int, mean, std):
    """(global view + crops as (n, 3, 336, 336) float32 normalized,
    w_crop, h_crop)."""
    trans = img.shape[1] < img.shape[0]
    if trans:
        img = img.transpose(1, 0, 2)
    h, w = img.shape[:2]
    ratio = w / h
    scale = 1
    while scale * math.ceil(scale / ratio) <= num_crops:
        scale += 1
    scale -= 1
    new_w = int(scale * CROP)
    new_h = int(new_w / ratio)
    img = pil_bilinear(img, new_w, new_h)
    tar = int(math.ceil(new_h / CROP) * CROP)
    top = (tar - new_h) // 2
    img = np.pad(img, ((top, tar - new_h - top), (0, 0), (0, 0)),
                 constant_values=255)
    if trans:
        img = img.transpose(1, 0, 2)
    hh, ww = img.shape[:2]
    h_crop, w_crop = hh // CROP, ww // CROP
    glob = pil_bilinear(img, CROP, CROP)
    crops = [glob] + [img[i * CROP:(i + 1) * CROP, j * CROP:(j + 1) * CROP]
                      for i in range(h_crop) for j in range(w_crop)]
    x = np.stack(crops).astype(np.float32) / 255.0
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2)), w_crop, h_crop


# -- products ----------------------------------------------------------
def _div(a: torch.Tensor, v: float) -> torch.Tensor:
    return a / torch.full_like(a, v)


def exact_q8(x: torch.Tensor, m) -> torch.Tensor:
    """x @ W^T in lm.rs's integer arithmetic for a Q8_0 weight (module
    note): x (N, K) float32 -> (N, O) float32."""
    n, k = x.shape
    gs = m.gs
    g = x.reshape(n, k // gs, gs)
    amax = g.abs().amax(dim=-1)
    xs = _div(amax, 127.0)
    safe = torch.where(xs == 0, torch.ones_like(xs), xs)
    r = g / safe[..., None]
    q = torch.trunc(r + torch.where(r >= 0, 0.5, -0.5))
    q = torch.where(xs[..., None] == 0, torch.zeros_like(q), q)
    wq = m.q.float().reshape(m.out_f, k // gs, gs)
    dots = torch.einsum("ngk,ogk->gno", q, wq)
    scaled = dots * xs.t()[:, :, None] * m.s.float().t()[:, None, :]
    y = scaled[0]
    for part in scaled[1:]:          # lm.rs adds the groups in order
        y = y + part
    return y


def layernorm(x, w, b, eps):
    """Layer norm (biased variance), scaled by 1 / sqrt(var + eps)."""
    mu = x.mean(-1, keepdim=True)
    d = x - mu
    inv = 1.0 / torch.sqrt((d * d).mean(-1, keepdim=True) + eps)
    return d * inv * w + b


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654
                                       * (x + 0.044715 * x ** 3)))


class Phi3V(Phi3):
    def __init__(self, conf: dict, weights, **kw):
        super().__init__(conf, weights.text, **kw)
        self.v = weights.vision
        self.vc = conf["vision"]
        self.num_crops = conf["preprocessor"]["num_crops"]
        self.mean = conf["preprocessor"]["image_mean"]
        self.std = conf["preprocessor"]["image_std"]

    # an image in a sequence: ("image", (H, W, seed))
    def item_length(self, item) -> int:
        return self._crops(item)[2] + len(PREFIX_IDS) + len(SUFFIX_IDS)

    def _crops(self, item):
        img = image_pixels(item[1])
        x, w_crop, h_crop = hd_crops(img, self.num_crops, self.mean,
                                     self.std)
        rows = h_crop * 12 * (w_crop * 12 + 1) + 1 + 12 * 13
        return x, (w_crop, h_crop), rows

    def item_rows(self, item, device) -> torch.Tensor:
        x, (w_crop, h_crop), _ = self._crops(item)
        feats = self.tower(torch.from_numpy(x).to(device))
        img = self.project(feats, w_crop, h_crop)
        return torch.cat([self.embed_ids(PREFIX_IDS, device), img,
                          self.embed_ids(SUFFIX_IDS, device)])

    @torch.no_grad()
    def tower(self, crops: torch.Tensor) -> torch.Tensor:
        """(n, 3, 336, 336) -> (n, 576, D): the penultimate layer, CLS
        dropped."""
        v, c = self.v, self.vc
        d, ps = c["hidden_size"], c["patch_size"]
        eps = c["layer_norm_eps"]
        nh = c["num_attention_heads"]
        hd = d // nh
        # the patch convolution (stride = kernel): each 14 x 14 patch's
        # channels-then-rows values against the kernel's
        n, _, side, _ = crops.shape
        g = side // ps
        patches = crops.reshape(n, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
        patches = patches.reshape(n, g * g, 3 * ps * ps)
        pe = patches @ v.patch_embedding.float().t()        # (n, 576, D)
        cls = v.class_embedding.float().expand(n, 1, d)
        h = torch.cat([cls, pe], dim=1) + v.position_embedding.float()[None]
        h = layernorm(h, v.pre_ln_w, v.pre_ln_b, eps)
        t = h.shape[1]
        for lw in v.layers[:c["num_hidden_layers"] - 1]:
            e = layernorm(h, lw["ln1_w"], lw["ln1_b"], eps).reshape(n * t, d)
            q = _div(exact_q8(e, lw["wq"]) + lw["wq_b"], math.sqrt(hd))
            k = exact_q8(e, lw["wk"]) + lw["wk_b"]
            vv = exact_q8(e, lw["wv"]) + lw["wv_b"]
            heads = lambda a: a.reshape(n, t, nh, hd).transpose(1, 2)  # noqa
            s = heads(q) @ heads(k).transpose(-1, -2)
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = p / p.sum(dim=-1, keepdim=True)
            att = (p @ heads(vv)).transpose(1, 2).reshape(n * t, d)
            h = h + (exact_q8(att, lw["wo"]) + lw["wo_b"]).reshape(n, t, d)
            e2 = layernorm(h, lw["ln2_w"], lw["ln2_b"], eps)
            mid = exact_q8(e2.reshape(n * t, d), lw["w1"]) + lw["w1_b"]
            mid = mid * torch.sigmoid(1.702 * mid)
            h = h + (exact_q8(mid, lw["w2"]) + lw["w2_b"]).reshape(n, t, d)
        return h[:, 1:]

    @torch.no_grad()
    def project(self, feats: torch.Tensor, w_crop: int,
                h_crop: int) -> torch.Tensor:
        """Tower features (1 + crops, 576, D) -> (rows, text width)."""
        v = self.v

        def grid(f, hc, wc):
            n, l, c = f.shape
            s = int(math.isqrt(l))
            f = f.reshape(n, s // 2, 2, s // 2, 2, c).permute(0, 1, 3, 2, 4,
                                                               5)
            f = f.reshape(hc, wc, s // 2, s // 2, 4 * c)
            f = f.permute(0, 2, 1, 3, 4).reshape(hc * s // 2, wc * s // 2,
                                                 4 * c)
            sep = v.sub_gn.float().expand(f.shape[0], 1, 4 * c)
            return torch.cat([f, sep], dim=1).reshape(-1, 4 * c)

        seq = torch.cat([grid(feats[1:], h_crop, w_crop),
                         v.glb_gn.float()[None], grid(feats[:1], 1, 1)])
        hid = gelu_tanh(exact_q8(seq, v.proj0) + v.proj0_b)
        return exact_q8(hid, v.proj1) + v.proj1_b


MODEL = Phi3V
