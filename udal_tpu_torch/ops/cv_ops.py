"""cv2's image operations, reimplemented without cv2 for the augmentations,
the Validator's augmented serves and the active-learning hashes.

The machine with the card has no cv2, so every cv2 call of the JAX
package's ``data/augment.py``, ``data/autoaugment.py``,
``apps/active_learning.py``, ``apps/al_eval.py`` and ``apps/validate.py``
has its counterpart here, held against cv2 5.0 in
``tests/test_torch_cv_ops.py``. Each function says how close it comes:

- bit for bit: ``rgb_to_gray``, ``equalize_hist``,
  ``rgb_to_yuv`` / ``yuv_to_rgb``, ``rgb_to_hsv`` / ``hsv_to_rgb``,
  ``rgb_to_hls`` / ``hls_to_rgb``, ``rgb_to_lab`` / ``lab_to_rgb``, ``clahe``,
  ``warp_affine_nearest``, ``rotation_matrix_2d``, ``box_blur``,
  ``dilate_2x2``, ``draw_line`` at thickness 1, ``filter2d`` below 130
  taps, ``calc_hist_3d``, ``gaussian_blur_f64`` at its default 7x7 and
  σ = 7/6, ``rectangle`` at every thickness (and ``ops.image_ops``'
  Gaussian blur of uint8 frames at every odd size);
- exact: ``get_text_size`` and ``put_text`` of ``FONT_HERSHEY_SIMPLEX`` at
  thickness 1 and the scales 0.4 and 0.45 (the drawing code's two; others
  raise): cv2 5.0 draws that font from an antialiased outline font, whose
  glyphs' coverage the port carries as measured (``ops.text_glyphs``);
- within a bound: ``filter2d`` at 130 taps or more (cv2 takes its DFT
  there: off by at most 1 where the exact sum is a tie), ``draw_line``
  thicker than 1 (a capsule, where cv2 fills a polygon and two discs),
  ``gaussian_blur3_f32`` (within 1e-4) and ``resize_area`` (within 1e-5
  relative).

cv2's 8-bit colour conversions to and from HSV and HLS compute in f32,
and their vector loops round otherwise than their scalar tails (the
vector HSV → RGB truncates, the vector RGB → HLS fuses a multiply-add the
tail does not): which pixel takes which path depends on its column, so
those functions emulate the layout of cv2 5.0 built for AVX2, the build the
tests compare with (vectors of 32 bytes for HSV → RGB, of 8 floats in
blocks of 256 pixels for RGB → HLS).

Host functions take and return numpy arrays; ``equalize_hist``,
``filter2d``, ``gaussian_blur3_f32`` and the YUV conversions also take
torch tensors and compute on their device (the Validator's batches).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from udal_tpu_torch.ops.image_ops import reflect101_index
from udal_tpu_torch.ops import text_glyphs
from udal_tpu_torch.ops.text_metrics import FIRST_CHAR, SIMPLEX

Array = Union[np.ndarray, torch.Tensor]
F32 = np.float32


def _fma32(a, b, c) -> np.ndarray:
    """f32 fused multiply-add: the product exact in f64, one rounding to f32
    after the add (as the FMA units round)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _channels(img: Array):
    if isinstance(img, torch.Tensor):
        x = img.to(torch.int32)
        return x[..., 0], x[..., 1], x[..., 2]
    x = np.asarray(img).astype(np.int32)
    return x[..., 0], x[..., 1], x[..., 2]


def _stack_u8(chans, like: Array) -> Array:
    if isinstance(like, torch.Tensor):
        return torch.stack(chans, -1).clamp(0, 255).to(torch.uint8)
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Colour conversions of uint8 RGB
# ---------------------------------------------------------------------------

def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2GRAY)`` of uint8: 15-bit fixed point."""
    r, g, b = _channels(img)
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def rgb_to_yuv(img: Array) -> Array:
    """``COLOR_RGB2YUV`` of uint8 (numpy, or a tensor on its device): 14-bit
    fixed point, U and V offset by 128."""
    r, g, b = _channels(img)
    y = (r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14
    u = ((b - y) * 8061 + (128 << 14) + (1 << 13)) >> 14
    v = ((r - y) * 14369 + (128 << 14) + (1 << 13)) >> 14
    return _stack_u8([y, u, v], img)


def yuv_to_rgb(img: Array) -> Array:
    """``COLOR_YUV2RGB`` of uint8 (numpy, or a tensor on its device)."""
    y, u, v = _channels(img)
    u, v = u - 128, v - 128
    r = y + ((v * 18678 + (1 << 13)) >> 14)
    g = y + ((v * -9519 + u * -6472 + (1 << 13)) >> 14)
    b = y + ((u * 33292 + (1 << 13)) >> 14)
    return _stack_u8([r, g, b], img)


def _hue_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << 12) / i)
    hdiv[1:] = np.rint((180 << 12) / (6.0 * i))
    return sdiv, hdiv


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``COLOR_RGB2HSV`` of uint8 (H in [0, 180)): cv2's 12-bit fixed
    point with its reciprocal tables."""
    sdiv, hdiv = _hue_tables()
    r, g, b = (c.astype(np.int64) for c in _channels(img))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _pick_sector(tab: np.ndarray, sector: np.ndarray) -> np.ndarray:
    """[..., 4] table → RGB by cv2's sector map (which lists B, G, R)."""
    return np.take_along_axis(tab, _SECTORS[sector], -1)[..., ::-1]


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``COLOR_HSV2RGB`` of uint8. cv2 computes in f32 with fused
    multiply-adds; its vector loop (each row's first ``W // 32 * 32``
    pixels) truncates the result, its scalar tail rounds it."""
    h = img[..., 0].astype(F32) * F32(6.0 / 180)
    s = img[..., 1].astype(F32) * F32(1.0 / 255)
    v = img[..., 2].astype(F32) * F32(1.0 / 255)
    whole = np.trunc(h)
    frac = (h - whole).astype(F32)
    sector = (whole - np.trunc(whole * F32(1.0 / 6)) * F32(6)).astype(np.int64)
    one = F32(1)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, frac, one),
                    v * _fma32(-s, one - frac, one)], -1).astype(F32)
    rgb = (_pick_sector(tab, sector) * F32(255)).astype(F32)
    w = img.shape[-2]
    vector = (np.arange(w) < w // 32 * 32)[:, None]           # [W, 1] against [..., W, 3]
    return np.clip(np.where(vector, np.trunc(rgb), np.rint(rgb)), 0, 255).astype(np.uint8)


def rgb_to_hls(img: np.ndarray) -> np.ndarray:
    """``COLOR_RGB2HLS`` of uint8 (H in [0, 180)), cv2's f32 arithmetic.
    Each row goes in blocks of 256 pixels; in a block, vectors of 8 add
    360° to a negative hue inside the fused multiply-add and take
    ``2 − (max + min)`` for the saturation's divisor, the block's last
    ``n % 8`` pixels add the 360° after it and take ``(2 − max) − min``."""
    r, g, b = (img[..., k].astype(F32) * F32(1.0 / 255) for k in range(3))
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = (vmax - vmin).astype(F32)
    light = ((vmax + vmin) * F32(0.5)).astype(F32)
    w = img.shape[-2]
    col = np.arange(w)
    start = col // 256 * 256
    vector = col < start + (np.minimum(start + 256, w) - start) // 8 * 8
    chromatic = diff > np.finfo(F32).eps
    with np.errstate(divide="ignore", invalid="ignore"):
        step = (F32(60) / diff).astype(F32)
        comp = np.where(vmax == r, g - b, np.where(vmax == g, b - r, r - g)).astype(F32)
        offset = np.where(vmax == r, F32(0), np.where(vmax == g, F32(120), F32(240))).astype(F32)
        hue_tail = _fma32(comp, step, offset)
        hue_tail = np.where(hue_tail < 0, hue_tail + F32(360), hue_tail).astype(F32)
        hue_vec = _fma32(comp, step, np.where((vmax == r) & (comp < 0), F32(360), offset))
        sat_low = (diff / (vmax + vmin)).astype(F32)
        sat_vec = (diff / (F32(2) - (vmax + vmin))).astype(F32)
        sat_tail = (diff / ((F32(2) - vmax) - vmin)).astype(F32)
    hue = np.where(chromatic, np.where(vector, hue_vec, hue_tail), F32(0))
    sat = np.where(chromatic, np.where(light < F32(0.5), sat_low,
                                       np.where(vector, sat_vec, sat_tail)), F32(0))
    out = np.stack([np.rint((hue * F32(0.5)).astype(F32)), np.rint((light * F32(255)).astype(F32)),
                    np.rint((sat * F32(255)).astype(F32))], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def hls_to_rgb(img: np.ndarray) -> np.ndarray:
    """``COLOR_HLS2RGB`` of uint8, cv2's f32 arithmetic, rounded."""
    h = img[..., 0].astype(F32) * F32(6.0 / 180)
    light = img[..., 1].astype(F32) * F32(1.0 / 255)
    s = img[..., 2].astype(F32) * F32(1.0 / 255)
    one = F32(1)
    p2 = np.where(light <= F32(0.5), light * (one + s), light + s - light * s).astype(F32)
    p1 = (F32(2) * light - p2).astype(F32)
    h = np.where(h >= F32(6), h - F32(6), h).astype(F32)
    sector = np.floor(h).astype(np.int64)
    frac = (h - sector.astype(F32)).astype(F32)
    tab = np.stack([p2, p1, p1 + (p2 - p1) * (one - frac), p1 + (p2 - p1) * frac], -1).astype(F32)
    rgb = np.where((s == 0)[..., None], light[..., None], _pick_sector(tab, sector))
    return np.clip(np.rint((rgb * F32(255)).astype(F32)), 0, 255).astype(np.uint8)


# cv2's Lab constants: sRGB → XYZ (D65), its inverse, the white point
_SRGB2XYZ = np.array([0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
                      0.019334, 0.119193, 0.950227]).reshape(3, 3)
_XYZ2SRGB = np.array([3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
                      0.055648, -0.204043, 1.057311]).reshape(3, 3)
_D65 = np.array([0.950456, 1.0, 1.088754])
_LAB_BASE = 1 << 14
_AB_MIN = -8145


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _lab_forward_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's integer RGB → Lab tables: the sRGB gamma (3 fraction bits),
    the cube root (15), the XYZ coefficients over the white point (12)."""
    x = (np.arange(256, dtype=F32) / F32(255)).astype(F32)
    gamma = np.where(x <= F32(0.04045), x / F32(12.92),
                     np.power(((x + F32(0.055)) / F32(1.055)).astype(F32), F32(2.4))).astype(F32)
    gamma_tab = np.rint(F32(255 * 8) * gamma).astype(np.int64)
    t = (np.arange(256 * 3 // 2 * 8, dtype=F32) / F32(255 * 8)).astype(F32)
    cbrt = np.where(t < F32(0.008856), t * F32(7.787) + F32(16.0 / 116), np.cbrt(t)).astype(F32)
    cbrt_tab = np.rint(F32(1 << 15) * cbrt).astype(np.int64)
    coeffs = np.rint(_SRGB2XYZ * ((1 << 12) / _D65)[:, None]).astype(np.int64)
    return gamma_tab, cbrt_tab, coeffs


def rgb_to_lab(img: np.ndarray) -> np.ndarray:
    """``COLOR_RGB2LAB`` of uint8: cv2's integer path (gamma and cube-root
    tables, 12- and 15-bit fixed point), bit for bit."""
    gamma_tab, cbrt_tab, c = _lab_forward_tables()
    rgb = [gamma_tab[img[..., k]] for k in range(3)]
    fx, fy, fz = (cbrt_tab[_descale(rgb[0] * c[i, 0] + rgb[1] * c[i, 1] + rgb[2] * c[i, 2], 12)]
                  for i in range(3))
    light = _descale(((116 * 255 + 50) // 100) * fy - ((16 * 255 * (1 << 15) + 50) // 100), 15)
    a = _descale(500 * (fx - fy) + (128 << 15), 15)
    b = _descale(200 * (fy - fz) + (128 << 15), 15)
    return np.clip(np.stack([light, a, b], -1), 0, 255).astype(np.uint8)


def _tdiv(a, b: int):
    """C's integer division (toward zero)."""
    q = np.abs(a) // abs(b)
    return np.where((np.asarray(a) < 0) != (b < 0), -q, q)


def lab_to_rgb(img: np.ndarray) -> np.ndarray:
    """``COLOR_LAB2RGB`` of uint8: cv2's integer path, bit for bit. Y and
    f(Y) of L in 14-bit fixed point (the linear segment up to L = 20),
    a/500 and b/200 by cv2's fixed-point reciprocals, f⁻¹ of f(Y) + a and
    f(Y) − b from its integer table (linear to 3390, else the cube in two
    truncating steps), 12-bit XYZ → RGB coefficients with the white point,
    then the inverse sRGB gamma as a 4096-entry table."""
    base = _LAB_BASE
    k = np.arange(256)
    lin = k * 100 / 255 / 903.3
    y_low = np.rint(k * base * 20 * 9 / (17 * 29 ** 3)).astype(np.int64)
    fy_low = np.rint(base * (lin * 7.787 + 16 / 116)).astype(np.int64)
    fy = (k * 100 / 255 + 16) / 116
    fy_high = np.rint(np.float32(fy * base)).astype(np.int64)
    y_high = np.rint(base * fy ** 3).astype(np.int64)
    y_tab = np.where(k <= 20, y_low, y_high)
    fy_tab = np.where(k <= 20, fy_low, fy_high)
    i = np.arange(_AB_MIN, base * 9 // 4 + _AB_MIN, dtype=np.int64)
    xz_tab = np.where(i <= 3390, _tdiv(i * 108, 841) - (base * 16 // 116) * 108 // 841,
                      (i * i // base) * i // base)
    t = (np.arange(4096, dtype=F32) / F32(4096)).astype(F32)
    inv_gamma = np.where(t <= F32(0.0031308), t * F32(12.92),
                         F32(1.055) * np.power(t, F32(1 / 2.4)).astype(F32) - F32(0.055))
    inv_gamma_tab = np.rint(F32(255) * inv_gamma.astype(F32)).astype(np.int64)
    c = np.rint(4096 * _XYZ2SRGB * _D65[None, :]).astype(np.int64)
    light, a, b = (img[..., q].astype(np.int64) for q in range(3))
    y, fy_l = y_tab[light], fy_tab[light]
    a_div = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * base // 500
    b_div = ((b * 41943 + (1 << 4)) >> 9) - 128 * base // 200 + 1
    x = xz_tab[fy_l + a_div - _AB_MIN]
    z = xz_tab[fy_l - b_div - _AB_MIN]
    rgb = [inv_gamma_tab[np.clip(_descale(c[j, 0] * x + c[j, 1] * y + c[j, 2] * z, 14), 0, 4095)]
           for j in range(3)]
    return np.stack(rgb, -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# Histograms
# ---------------------------------------------------------------------------

def equalize_hist(gray: Array) -> Array:
    """``cv2.equalizeHist`` of each uint8 plane of ``gray`` [..., H, W]
    (numpy, or a tensor on its device): the cumulative histogram above the
    first occupied level times 255 / (count − that level's count), in f32,
    rounded."""
    as_numpy = not isinstance(gray, torch.Tensor)
    x = torch.from_numpy(np.ascontiguousarray(gray)) if as_numpy else gray
    lead = x.shape[:-2]
    planes = x.reshape(-1, x.shape[-2] * x.shape[-1]).to(torch.int64)
    n, total = planes.shape
    hist = torch.zeros(n, 256, dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, planes, torch.ones_like(planes))
    cum = hist.cumsum(1)
    first = (hist > 0).to(torch.int8).argmax(1, keepdim=True)               # [n, 1]
    first_count = hist.gather(1, first)
    # a true f32 division (255 / t on a tensor multiplies by its reciprocal)
    scale = torch.full_like(first_count, 255, dtype=torch.float32) / \
        (total - first_count).clamp_min(1).to(torch.float32)
    lut = ((cum - first_count).to(torch.float32) * scale).round().clamp(0, 255)
    levels = torch.arange(256, device=x.device)[None]
    lut = torch.where(levels <= first, torch.zeros_like(lut), lut)
    # one occupied level: cv2 fills the plane with that level
    lut = torch.where(first_count == total, first.to(lut.dtype).expand_as(lut), lut)
    out = lut.to(torch.uint8).gather(1, planes).reshape(x.shape)
    return out.numpy() if as_numpy else out



def clahe(gray: np.ndarray, clip_limit: float, grid: int) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, (grid, grid)).apply(gray)`` of a uint8
    plane: a plane whose sides the grid does not divide is padded at the
    bottom and right by ``grid − side % grid`` (BORDER_REFLECT_101, both
    sides then); each tile's histogram is clipped and its excess spread
    (the remainder one by one at a stride); the tiles' LUTs are blended
    bilinearly in f32."""
    h, w = gray.shape
    if h % grid or w % grid:
        ext = gray[reflect101_index(h, 0, grid - h % grid)][:, reflect101_index(w, 0, grid - w % grid)]
    else:
        ext = gray
    th, tw = ext.shape[0] // grid, ext.shape[1] // grid
    area = th * tw
    lut_scale = F32(255) / F32(area)
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    tiles = ext[:th * grid, :tw * grid].reshape(grid, th, grid, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(grid * grid, area).astype(np.int64)
    hist = np.zeros((grid * grid, 256), np.int64)
    np.add.at(hist, (np.arange(grid * grid)[:, None], tiles), 1)
    if limit > 0:
        clipped = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        residual = clipped % 256
        for t in np.nonzero(residual)[0]:
            step = max(256 // int(residual[t]), 1)
            hist[t, np.arange(0, 256, step)[:residual[t]]] += 1
    luts = np.clip(np.rint((np.cumsum(hist, 1).astype(F32) * lut_scale).astype(F32)), 0, 255)
    luts = luts.reshape(grid, grid, 256)

    def axis(n, size):
        pos = (np.arange(n).astype(F32) * (F32(1) / F32(size)) - F32(0.5)).astype(F32)
        lo = np.floor(pos).astype(np.int64)
        frac = (pos - lo).astype(F32)
        return np.maximum(lo, 0), np.minimum(lo + 1, grid - 1), frac, (F32(1) - frac).astype(F32)

    y1, y2, ya, ya1 = axis(h, th)
    x1, x2, xa, xa1 = axis(w, tw)
    v = gray.astype(np.int64)
    top = luts[y1[:, None], x1[None], v] * xa1 + luts[y1[:, None], x2[None], v] * xa
    bottom = luts[y2[:, None], x1[None], v] * xa1 + luts[y2[:, None], x2[None], v] * xa
    res = (top.astype(F32) * ya1[:, None] + bottom.astype(F32) * ya[:, None]).astype(F32)
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def calc_hist_3d(img: np.ndarray, bins: int = 8) -> np.ndarray:
    """``cv2.calcHist([img], [0, 1, 2], None, [bins] * 3, [0, 256] * 3)``
    of uint8 (``bins`` a power of 2): integer counts as f32 [bins³]."""
    shift = 8 - int(math.log2(bins))
    q = np.asarray(img, np.uint8).reshape(-1, 3).astype(np.int64) >> shift
    idx = (q[:, 0] * bins + q[:, 1]) * bins + q[:, 2]
    return np.bincount(idx, minlength=bins ** 3).astype(np.float32)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: [2, 3] f64, the centre rounded to f32."""
    cx, cy = float(F32(center[0])), float(F32(center[1]))
    rad = angle * (math.pi / 180)
    a, b = math.cos(rad) * scale, math.sin(rad) * scale
    return np.array([[a, b, (1 - a) * cx - b * cy], [-b, a, b * cx + (1 - a) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * det, m[0, 0] * det, -m[0, 1] * det, -m[1, 0] * det
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine_nearest(img: np.ndarray, matrix: np.ndarray, border_value: int) -> np.ndarray:
    """``cv2.warpAffine(img, matrix, (w, h), flags=INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=border_value)``: the forward
    ``matrix`` [2, 3] inverted in f64, each destination pixel's source
    position in f32 from the f32 inverse M, rounded half to even; outside
    the image, ``border_value``. As cv2 5.0 for AVX2: each row's first
    ``W // 16 * 16`` pixels take fma(M0, x, M1·y + M2), the rest
    fma(M0, x, M1·y) + M2."""
    h, w = img.shape[:2]
    inv = _invert_affine(matrix).astype(F32)
    xs = np.arange(w, dtype=F32)[None, :]
    ys = np.arange(h, dtype=F32)[:, None]
    vector = np.arange(w) < w // 16 * 16

    def source(m0, m1, m2):
        vec = _fma32(m0, xs, (m1 * ys + m2).astype(F32))
        tail = (_fma32(m0, xs, m1 * ys) + m2).astype(F32)
        return np.rint(np.where(vector, vec, tail)).astype(np.int64)

    sx, sy = source(*inv[0]), source(*inv[1])
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.full_like(img, border_value)
    out[inside] = img[sy[inside], sx[inside]]
    return out


def resize_area(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=INTER_AREA)`` of a float
    image [H, W] or [H, W, C]: each output pixel the area-weighted mean of
    the source pixels its cell covers (cv2's weights, here summed in f64;
    within 1e-5 relative). Where an axis grows, cv2's INTER_AREA takes
    its bilinear weights for both axes, and so does this."""
    x = np.asarray(image, np.float64)
    h, w = int(size_hw[0]), int(size_hw[1])
    down = x.shape[0] >= h and x.shape[1] >= w
    wy = (_area_weights if down else _area_linear_weights)(x.shape[0], h)
    wx = (_area_weights if down else _area_linear_weights)(x.shape[1], w)
    out = np.tensordot(wy, x, axes=(1, 0))
    out = np.tensordot(wx, out, axes=(1, 1)).swapaxes(0, 1)
    return out.astype(np.float32)


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of cv2's ``computeResizeAreaTab``."""
    scale = src / dst
    weights = np.zeros((dst, src))
    for d in range(dst):
        lo = d * scale
        hi = lo + scale
        cell = min(scale, src - lo)
        first, last = math.ceil(lo), math.floor(hi)
        last = min(last, src - 1)
        first = min(first, last)
        if first - lo > 1e-3:
            weights[d, first - 1] += (first - lo) / cell
        weights[d, first:last] += 1.0 / cell
        if hi - last > 1e-3:
            weights[d, last] += min(min(hi - last, 1.0), cell) / cell
    return weights


def _area_linear_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of INTER_AREA where the image grows: cv2's linear
    taps with fx = (d + 1) − (s + 1)·dst/src, its fraction, 0 if negative."""
    weights = np.zeros((dst, src))
    inv = dst / src
    for d in range(dst):
        s = math.floor(d * (src / dst))
        fx = float(F32((d + 1) - (s + 1) * inv))
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if s < 0:
            s, fx = 0, 0.0
        if s >= src - 1:
            s, fx = src - 1, 0.0
        weights[d, s] += 1.0 - fx
        if fx:
            weights[d, s + 1] += fx
    return weights


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

def box_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` of uint8 (BORDER_REFLECT_101, anchor at
    the centre, ``k·k`` at most 256): integer window sums divided as cv2
    divides them, by a 23-bit multiplier and its rounding offset."""
    if ksize == 1:
        return img.copy()
    if ksize * ksize > 256:
        raise ValueError(f"box_blur takes k*k <= 256 (cv2's 16-bit sums), got k={ksize}")
    a = ksize // 2
    h, w = img.shape[:2]
    x = img.astype(np.int64)[reflect101_index(h, a, ksize - 1 - a)][:, reflect101_index(w, a, ksize - 1 - a)]
    pad = ((1, 0), (1, 0)) + ((0, 0),) * (img.ndim - 2)
    cs = np.cumsum(np.cumsum(np.pad(x, pad), 0), 1)
    s = cs[ksize:, ksize:] - cs[:-ksize, ksize:] - cs[ksize:, :-ksize] + cs[:-ksize, :-ksize]
    area = ksize * ksize
    exact = (1 << 23) / area
    div_scale, div_delta = int(exact), area // 2
    if exact - div_scale < 0.5:
        div_delta += 1
    else:
        div_scale += 1
    return ((s + div_delta) * div_scale >> 23).astype(np.uint8)


def dilate_2x2(x: np.ndarray) -> np.ndarray:
    """``cv2.dilate(x, np.ones((2, 2)))``: the max over each pixel, its
    left, upper and upper-left neighbours (outside counts as −inf)."""
    pad = ((1, 0), (1, 0)) + ((0, 0),) * (x.ndim - 2)
    p = np.pad(x, pad, constant_values=-np.inf)
    return np.maximum(np.maximum(p[1:, 1:], p[:-1, 1:]), np.maximum(p[1:, :-1], p[:-1, :-1]))


def filter2d(images: Array, kernel: np.ndarray) -> Array:
    """``cv2.filter2D(image, -1, kernel)`` of uint8 images [..., H, W, C]
    (numpy, or a tensor on its device): correlation with the f32 ``kernel``
    about its centre (``k // 2``), BORDER_REFLECT_101, the sum in f64 and
    rounded half to even. cv2 sums in f32 for kernels of fewer than 130
    taps, which rounds alike wherever the exact sum is no tie (the
    sharpness and 3- and 7-tap motion kernels: bit for bit); from 130 taps
    it convolves by DFT, which breaks ties either way (off by ≤ 1)."""
    as_numpy = not isinstance(images, torch.Tensor)
    x = torch.from_numpy(np.ascontiguousarray(images)) if as_numpy else images
    kernel = np.asarray(kernel, F32)
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = x.shape[-3], x.shape[-2]
    iy = torch.from_numpy(reflect101_index(h, ay, kh - 1 - ay)).to(x.device)
    ix = torch.from_numpy(reflect101_index(w, ax, kw - 1 - ax)).to(x.device)
    p = x.to(torch.float64).index_select(-3, iy).index_select(-2, ix)
    acc = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for i, j in zip(*np.nonzero(kernel)):
        acc += float(kernel[i, j]) * p[..., i:i + h, j:j + w, :]
    out = acc.round().clamp(0, 255).to(torch.uint8)
    return out.numpy() if as_numpy else out


def motion_kernel(k: int) -> np.ndarray:
    """The JAX package's motion-blur kernel: row ``k // 2`` of a [k, k]
    f32 zero matrix set to 1/k."""
    kernel = np.zeros((k, k), F32)
    kernel[k // 2, :] = 1.0 / k
    return kernel


def gaussian_blur3_f32(x: Array) -> Array:
    """``cv2.GaussianBlur(x, (3, 3), 0)`` of f32 [..., H, W] or [..., H, W, C]
    (set ``channels_last`` by the rank: 2 spatial axes are the last two of
    a plane, the two before the channel axis of an image): taps
    ¼, ½, ¼ along W then H in f32, BORDER_REFLECT_101 (within 1e-4 of cv2
    for values up to 400)."""
    as_numpy = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(x, F32)) if as_numpy else x.to(torch.float32)
    hw = (-2, -1) if t.dim() == 2 else (-3, -2)
    h, w = t.shape[hw[0]], t.shape[hw[1]]
    t = t.index_select(hw[1], torch.from_numpy(reflect101_index(w, 1, 1)).to(t.device))
    t = 0.25 * t.narrow(hw[1], 0, w) + 0.5 * t.narrow(hw[1], 1, w) + 0.25 * t.narrow(hw[1], 2, w)
    t = t.index_select(hw[0], torch.from_numpy(reflect101_index(h, 1, 1)).to(t.device))
    t = 0.25 * t.narrow(hw[0], 0, h) + 0.5 * t.narrow(hw[0], 1, h) + 0.25 * t.narrow(hw[0], 2, h)
    return t.numpy() if as_numpy else t


# cv2.getGaussianKernel(7, 7/6, CV_64F), as cv2 5.0 computes it (in its
# software double arithmetic, whose exp differs from libm's in the last bit)
_GAUSSIAN_7_SIGMA_7_6 = [float.fromhex(v) for v in (
    "0x1.9b92991f2487fp-7", "0x1.42e11ca517a5fp-4", "0x1.e5fb7c557fad1p-3",
    "0x1.5edacbc602377p-2", "0x1.e5fb7c557fad1p-3", "0x1.42e11ca517a5fp-4",
    "0x1.9b92991f2487fp-7")]


def gaussian_kernel_f64(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_64F)`` for an odd ``ksize``
    and σ > 0: cv2's own values at (7, 7/6); elsewhere its formula
    (exp(−x²/2σ²) at the half-integer-free offsets, normalised by one
    reciprocal) in libm's arithmetic, within two ulps of cv2's."""
    if ksize % 2 == 0 or sigma <= 0:
        raise ValueError(f"gaussian_kernel_f64 takes an odd ksize and sigma > 0, "
                         f"got {ksize}, {sigma}")
    if ksize == 7 and sigma == 7.0 / 6.0:
        return np.array(_GAUSSIAN_7_SIGMA_7_6)
    scale2 = -0.125 / (sigma * sigma)     # the offsets are taken doubled
    values = [math.exp(float(x * x) * scale2) for x in range(1 - ksize, 0, 2)]
    norm = 1.0 / (2 * sum(values) + 1.0)
    half = [v * norm for v in values]
    return np.array(half + [norm] + half[::-1])


_SPLIT = 134217729.0                       # 2^27 + 1, Veltkamp's splitter


def _fma64(a: np.ndarray, b: float, c: np.ndarray) -> np.ndarray:
    """f64 fused multiply-add, a·b + c rounded once: the product's error
    and the sum's recovered exactly (Dekker, Knuth) and added back."""
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    al = a - ah
    t = _SPLIT * b
    bh = t - (t - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bp = s - p
    return s + (((p - (s - bp)) + (c - bp)) + e)


def gaussian_blur_f64(x: np.ndarray, ksize: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    """``cv2.GaussianBlur(x, (ksize, ksize), sigma)`` of an f64 plane [H, W]
    (BORDER_REFLECT_101), as cv2 5.0 built for AVX2 filters f64: along
    W each output sums its taps in order, with fused multiply-adds in each
    row's first ``W // 4 * 4`` columns (its unrolled loop) and separate
    roundings in the rest; along H the symmetric kernel's centre tap,
    then each pair of mirrored rows summed before its tap multiplies it.
    A plane of one row skips the pass along H, one of one column the pass
    along W (cv2 drops the kernel along an axis of length 1). Bit for bit
    with cv2 at the default 7x7 and σ = 7/6."""
    x = np.asarray(x, np.float64)
    k = gaussian_kernel_f64(ksize, sigma)
    a = ksize // 2
    h, w = x.shape
    rows = x
    if w > 1:
        p = x[:, reflect101_index(w, a, a)]
        vec = w // 4 * 4
        rows = k[0] * p[:, :w]
        for j in range(1, ksize):
            tap = p[:, j:j + w]
            rows = np.concatenate([_fma64(tap[:, :vec], k[j], rows[:, :vec]),
                                   rows[:, vec:] + k[j] * tap[:, vec:]], axis=1)
    if h == 1:
        return rows
    p = rows[reflect101_index(h, a, a)]
    out = k[a] * p[a:a + h]
    for j in range(1, a + 1):
        out = out + k[a + j] * (p[a + j:a + j + h] + p[a - j:a - j + h])
    return out


# ---------------------------------------------------------------------------
# Drawing
# ---------------------------------------------------------------------------

def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` (integer endpoints, f64 intercepts truncated)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line_pixels(w: int, h: int, p1: Tuple[int, int], p2: Tuple[int, int]) -> np.ndarray:
    """[n, 2] (x, y) pixels of cv2's 8-connected line from ``p1`` to ``p2``
    (x, y) in a ``w`` x ``h`` image: clipped as ``clipLine`` clips, drawn
    left to right by ``LineIterator``'s Bresenham steps."""
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return np.zeros((0, 2), np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, step_y = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, step_y = -dy, -1
    vertical = dy > dx
    if vertical:
        dx, dy = dy, dx
    # LineIterator steps the minor axis where its error term, dx − 2·dy
    # + 2·dx·minor − 2·dy·i, is negative: minor_i = ⌈(2·dy·i − dx) / (2·dx)⌉⁺
    major = np.arange(dx + 1)
    minor = np.maximum(0, -((dx - 2 * dy * major) // (2 * dx))) if dx else major
    if vertical:
        xs, ys = x1 + minor, y1 + step_y * major
    else:
        xs, ys = x1 + major, y1 + step_y * minor
    return np.stack([xs, ys], -1)


def draw_line(canvas: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color,
              thickness: int = 1) -> None:
    """``cv2.line(canvas, p1, p2, color, thickness)`` in place (LINE_8).
    Thickness 1 is cv2's line pixel for pixel. cv2 draws a thicker line
    as a polygon of half-width r = (t + t % 2) / 2 and two discs of that
    radius in fixed point; here it is the capsule of pixels whose centre
    lies within r + ½ of the segment: the two differ on 5–14% of the
    pixels either draws (the tests bound it at 15%)."""
    h, w = canvas.shape[:2]
    if thickness <= 1:
        pts = line_pixels(w, h, p1, p2)
        canvas[pts[:, 1], pts[:, 0]] = color
        return
    r = (thickness + thickness % 2) / 2.0 + 0.5
    (x1, y1), (x2, y2) = (float(p1[0]), float(p1[1])), (float(p2[0]), float(p2[1]))
    lo_x, hi_x = max(int(math.floor(min(x1, x2) - r)), 0), min(int(math.ceil(max(x1, x2) + r)), w - 1)
    lo_y, hi_y = max(int(math.floor(min(y1, y2) - r)), 0), min(int(math.ceil(max(y1, y2) + r)), h - 1)
    if lo_x > hi_x or lo_y > hi_y:
        return
    ys, xs = np.mgrid[lo_y:hi_y + 1, lo_x:hi_x + 1].astype(np.float64)
    dx, dy = x2 - x1, y2 - y1
    length2 = dx * dx + dy * dy
    t = np.clip(((xs - x1) * dx + (ys - y1) * dy) / length2, 0, 1) if length2 else 0.0
    dist2 = (xs - (x1 + t * dx)) ** 2 + (ys - (y1 + t * dy)) ** 2
    inside = dist2 <= r * r
    canvas[lo_y:hi_y + 1, lo_x:hi_x + 1][inside] = color


def _fill(canvas: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """Fill the inclusive box between two corners, clipped to the canvas."""
    h, w = canvas.shape[:2]
    x1, x2 = sorted((x1, x2))
    y1, y2 = sorted((y1, y2))
    x1, y1, x2, y2 = max(x1, 0), max(y1, 0), min(x2, w - 1), min(y2, h - 1)
    if x1 <= x2 and y1 <= y2:
        canvas[y1:y2 + 1, x1:x2 + 1] = color


def rectangle(canvas: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color,
              thickness: int = 1) -> None:
    """``cv2.rectangle(canvas, p1, p2, color, thickness)`` in place
    (LINE_8, integer corners (x, y)), bit for bit at thickness 1, 2 and −1.
    cv2 draws the closed outline side by side from the left edge's lower
    end: at thickness 1 each side is ``draw_line``; at 2 each side is a
    band one pixel to either side of it (cv2's polygon of half-width 1)
    and each side's end a disc of radius 1 (the pixel and its four
    neighbours); −1 fills the box. Thicker outlines are not drawn here."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if thickness < 0:
        _fill(canvas, x1, y1, x2, y2, color)
        return
    sides = [((x1, y2), (x1, y1)), ((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)),
             ((x2, y2), (x1, y2))]
    if thickness <= 1:
        for a, b in sides:
            draw_line(canvas, a, b, color)
        return
    if thickness != 2:
        raise ValueError(f"rectangle draws thickness 1, 2 or -1, got {thickness}")
    for (ax, ay), (bx, by) in sides:
        if ay == by and ax != bx:
            _fill(canvas, ax, ay - 1, bx, by + 1, color)
        elif ax == bx and ay != by:
            _fill(canvas, ax - 1, ay, bx + 1, by, color)
        _fill(canvas, bx - 1, by, bx + 1, by, color)
        _fill(canvas, bx, by - 1, bx, by + 1, color)


def _glyphs(text: str, scale: float, thickness: int, what: str):
    """The table indices of ``text``'s characters as cv2 5.0 draws them
    from its font: the text ends at a NUL, and a control character (other
    than a newline) is drawn as "?". cv2 draws most of Unicode from its
    font and lays out several lines by rules of its own; the port carries
    printable ASCII's glyphs and draws one line, and raises on the rest."""
    if thickness != 1 or scale not in SIMPLEX:
        raise ValueError(f"{what} knows thickness 1 at scales {sorted(SIMPLEX)}, "
                         f"got thickness {thickness}, scale {scale}")
    text = text.split("\0", 1)[0]
    codes = [ord("?") if (c < 32 and c != 10) or c == 127 else c for c in map(ord, text)]
    bad = [chr(c) for c in codes if c == 10 or c > 126]
    if bad:
        raise ValueError(f"{what} draws one line of printable ASCII (control characters "
                         f"as '?'), got {bad[0]!r} in {text!r}")
    return [c - FIRST_CHAR for c in codes]


def get_text_size(text: str, scale: float, thickness: int = 1) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, scale, thickness)`` of
    one line at thickness 1 and scale 0.4 or 0.45: ((width, height),
    baseline) from cv2 5.0's measured metrics (``ops.text_metrics``): one
    pixel plus the characters' advances, the scale's height, the deepest
    character's baseline; ((0, 0), 0) for an empty text. Characters as
    ``_glyphs`` reads them."""
    idx = _glyphs(text, scale, thickness, "get_text_size")
    if not idx:
        return (0, 0), 0
    table = SIMPLEX[scale]
    width = 1 + sum(table["advance"][i] for i in idx)
    return (width, table["height"]), max(table["baseline"][i] for i in idx)


def put_text(canvas: np.ndarray, text: str, org: Tuple[int, int], scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """``cv2.putText(canvas, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness)`` in place on a uint8 image, bit for bit with cv2 5.0 at
    thickness 1 and scale 0.4 or 0.45 (default line type): each glyph's
    coverage a (``ops.text_glyphs``) composited in order at whole-pixel
    advances from ``org`` (x, y: the baseline's left end), each pixel
    blended as (bg·(255 − a) + color·a + 127) // 255 and clipped at the
    image's edges; as in cv2, no glyph is drawn from an origin at or past
    the right edge. Characters as ``_glyphs`` reads them. Returns
    ``canvas``."""
    idx = _glyphs(text, scale, thickness, "put_text")
    maps = text_glyphs.coverage(scale)
    advance = SIMPLEX[scale]["advance"]
    h, w = canvas.shape[:2]
    rows, cols = text_glyphs.BOX
    col = np.asarray(color, np.int32)[: canvas.shape[2] if canvas.ndim == 3 else 1]
    x, y = int(org[0]), int(org[1])
    for i in idx:
        if x >= w:                  # cv2 stops at a glyph whose origin is past the edge
            break
        r0, c0 = y - text_glyphs.ROW0, x - text_glyphs.COL0
        rs, re_, cs, ce = max(r0, 0), min(r0 + rows, h), max(c0, 0), min(c0 + cols, w)
        if rs < re_ and cs < ce:
            a = maps[i, rs - r0:re_ - r0, cs - c0:ce - c0].astype(np.int32)
            view = canvas[rs:re_, cs:ce]
            if canvas.ndim == 3:
                a = a[..., None]
            bg = view.astype(np.int32)
            view[...] = ((bg * (255 - a) + col * a + 127) // 255).astype(canvas.dtype)
        x += advance[i]
    return canvas
