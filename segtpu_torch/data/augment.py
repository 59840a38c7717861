"""On-device data augmentation (port of ``segtpu/data/augment.py``).

The reference writes augmented copies to disk through Albumentations and
cv2 and reads them back every epoch (dataset.py:140-210,
forward_selection_integration.py:62-181). Here every transform works on
a batch of *canonical frames* (the resized square frames the model sees)
on their device.

Each transform keeps its random draws apart from its arithmetic:
``draw(generator, n, s, raw_hw=None)`` gives its parameters, one row per
image, from an explicit ``torch.Generator`` on the device, and
``apply(images, masks, params)`` is deterministic. Images are float32
(N, S, S) in [0, 255], masks float32 (N, S, S).

Parity with the JAX package: the same transforms, parameter ranges,
probabilities, coordinate formulas and interpolation taps, so that a
transform's apply equals the JAX transform given the same draws; the
random streams differ (JAX's PRNG is not torch's). Warps sample
bilinearly (images) and nearest (masks) by gathering the floor and ceil
taps of each axis with the (1−f, f) weights; a reflect border folds the
coordinate (cv2 BORDER_REFLECT_101), a constant border gives a tap
outside the grid the weight 0 (cv2's partial border blending). The JAX
package writes the same sampling as dense one-hot matmuls for the TPU's
matrix unit; a gather is the GPU's form. Masks move with the geometric
transforms; intensity, blur and dropout transforms leave them alone
(Albumentations semantics). ``random_crop`` and ``downscale`` are
raw-frame aware: given each image's raw shape they fold the reference's
raw-pixel magnitudes into the canonical frame.

The 7×7 blur is 49 shifted multiply-adds with a kernel per image, not a
cuDNN convolution, which runs in TF32 by default on Hopper.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from segtpu_torch import resolve_device

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- samplers

def _reflect101_idx(i: torch.Tensor, n: int) -> torch.Tensor:
    """cv2 BORDER_REFLECT_101 folding of integer indices (…dcb|abcd|cba…)."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = i.abs() % period
    return torch.where(m >= n, period - m, m)


def _reflect101_coord(c: torch.Tensor, n: int) -> torch.Tensor:
    """BORDER_REFLECT_101 fold of float coordinates into [0, n−1].
    Reflection is an isometry, so folding the coordinate and sampling in
    range gives the same taps and weights as folding each integer tap."""
    if n == 1:
        return torch.zeros_like(c)
    period = float(2 * (n - 1))
    m = torch.fmod(c.abs(), period)
    return torch.where(m > n - 1, period - m, m)


def _taps(coords: torch.Tensor, n: int, border: str, nearest: bool):
    """[(index, weight)] of float coordinates on an axis of n pixels:
    floor(c + 0.5) with weight 1 (nearest), or floor(c) and floor(c) + 1
    with weights 1 − f and f (bilinear). A tap outside the axis weighs 0
    (its index is clamped only to keep the gather in bounds)."""
    c = _reflect101_coord(coords, n) if border == "reflect" else coords
    if nearest:
        taps = [(torch.floor(c + 0.5), torch.ones_like(c))]
    else:
        i0 = torch.floor(c)
        f = c - i0
        taps = [(i0, 1.0 - f), (i0 + 1.0, f)]
    out = []
    for i, w in taps:
        inside = (i >= 0) & (i <= n - 1)
        out.append((i.clamp(0, n - 1).long(),
                    torch.where(inside, w, torch.zeros_like(w))))
    return out


def _sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
            border: str, nearest: bool) -> torch.Tensor:
    """img (N, H, W) at per-image float coordinates ys, xs (N, ...) →
    (N, ...): each tap row's x taps first, then the rows' weights (the JAX
    package's order of sums)."""
    if border not in ("reflect", "constant"):
        raise ValueError(f"border must be 'reflect' or 'constant', got "
                         f"{border!r}")
    n, h, w = img.shape
    flat = img.reshape(n, h * w)
    yt = _taps(ys.reshape(n, -1), h, border, nearest)
    xt = _taps(xs.reshape(n, -1), w, border, nearest)
    out = None
    for iy, wy in yt:
        row = None
        for ix, wx in xt:
            v = torch.gather(flat, 1, iy * w + ix) * wx
            row = v if row is None else row + v
        v = row * wy
        out = v if out is None else out + v
    return out.reshape(ys.shape)


def sample_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    border: str = "reflect") -> torch.Tensor:
    """Bilinear samples of img (N, H, W) at float coordinates (N, ...)."""
    return _sample(img, ys, xs, border, nearest=False)


def sample_nearest(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                   border: str = "reflect") -> torch.Tensor:
    """Nearest samples (floor(c + 0.5)) of img (N, H, W)."""
    return _sample(img, ys, xs, border, nearest=True)


def _warp_pair(img, mask, ys, xs, border):
    return (sample_bilinear(img, ys, xs, border),
            sample_nearest(mask, ys, xs, border))


def _mesh(s: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yy, xx) float32 (S, S) pixel coordinates."""
    ar = torch.arange(s, dtype=torch.float32, device=device)
    return ar[:, None].expand(s, s), ar[None, :].expand(s, s)


def _col(t: torch.Tensor) -> torch.Tensor:
    """(N,) per-image parameter → (N, 1, 1), to broadcast over a frame."""
    return t[:, None, None]


# ------------------------------------------------------------- draws

def _uniform(gen: torch.Generator, n: int, lo: float, hi: float,
             *shape) -> torch.Tensor:
    u = torch.rand((n, *shape), generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def _randint(gen: torch.Generator, n: int, lo: int, hi: int,
             *shape) -> torch.Tensor:
    """Integers in [lo, hi)."""
    return torch.randint(lo, hi, (n, *shape), generator=gen,
                         device=gen.device)


class Transform:
    """A transform of a batch of canonical frames: ``draw`` its
    parameters (a dict of tensors, one row per image), ``apply`` them.
    ``moves_mask``: whether the mask moves with the image."""

    moves_mask = False

    def draw(self, gen: torch.Generator, n: int, s: int,
             raw_hw: Optional[torch.Tensor] = None) -> Params:
        return {}

    def apply(self, img: torch.Tensor, mask: torch.Tensor, params: Params
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


# ------------------------------------------------------------- geometric

class HorizontalFlip(Transform):
    moves_mask = True

    def apply(self, img, mask, params):
        return img.flip(-1), mask.flip(-1)


class VerticalFlip(Transform):
    moves_mask = True

    def apply(self, img, mask, params):
        return img.flip(-2), mask.flip(-2)


class Transpose(Transform):
    moves_mask = True

    def apply(self, img, mask, params):
        return img.transpose(-2, -1), mask.transpose(-2, -1)


class RandomRotate90(Transform):
    """k·90° counter-clockwise (``rot90`` in the frame's axes), k
    uniform in {0, 1, 2, 3}."""
    moves_mask = True

    def draw(self, gen, n, s, raw_hw=None):
        return {"k": _randint(gen, n, 0, 4)}

    def apply(self, img, mask, params):
        k, rows = params["k"], torch.arange(img.shape[0], device=img.device)
        return tuple(torch.stack([torch.rot90(t, r, (-2, -1))
                                  for r in range(4)])[k, rows]
                     for t in (img, mask))


class Affine(Transform):
    """A.Affine: independently drawn x/y scale, translation (a fraction of
    the frame), rotation and x-shear (degrees), about the frame's centre."""
    moves_mask = True

    def __init__(self, scale=(0.95, 1.05), translate=(-0.05, 0.05),
                 rotate=(-15.0, 15.0), shear=(-5.0, 5.0),
                 border: str = "constant"):
        self.scale, self.translate = scale, translate
        self.rotate, self.shear, self.border = rotate, shear, border

    def draw(self, gen, n, s, raw_hw=None):
        return {"sx": _uniform(gen, n, *self.scale),
                "sy": _uniform(gen, n, *self.scale),
                "tx": _uniform(gen, n, *self.translate),
                "ty": _uniform(gen, n, *self.translate),
                "rotate": _uniform(gen, n, *self.rotate),
                "shear": _uniform(gen, n, *self.shear)}

    @staticmethod
    def coords(params: Params, s: int):
        """(ys, xs) (N, S, S): the source coordinates of each output
        pixel, the inverse of M = R · Shear_x · Scale about the centre."""
        p = {k: _col(v) for k, v in params.items()}
        sx, sy = p["sx"], p["sy"]
        tx, ty = p["tx"] * s, p["ty"] * s
        th, sh = torch.deg2rad(p["rotate"]), torch.deg2rad(p["shear"])
        cos, sin, shr = torch.cos(th), torch.sin(th), torch.tan(sh)
        m00 = cos * sx
        m01 = cos * (shr * sy) - sin * sy
        m10 = sin * sx
        m11 = sin * (shr * sy) + cos * sy
        c = (s - 1) / 2.0
        t0 = c + tx - (m00 * c + m01 * c)
        t1 = c + ty - (m10 * c + m11 * c)
        det = m00 * m11 - m01 * m10
        i00, i01 = m11 / det, -m01 / det
        i10, i11 = -m10 / det, m00 / det
        yy, xx = _mesh(s, sx.device)
        px, py = xx - t0, yy - t1
        return i10 * px + i11 * py, i00 * px + i01 * py

    def apply(self, img, mask, params):
        ys, xs = self.coords(params, img.shape[-1])
        return _warp_pair(img, mask, ys, xs, self.border)


def _interp_to_index(x: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, arange(M))`` for increasing rows xp (N, M) and
    points x (M,): linear between neighbours, clamped at the ends."""
    m = xp.shape[1]
    xb = x.expand(xp.shape[0], m).contiguous()
    i = torch.searchsorted(xp, xb, right=True).clamp(1, m - 1)
    lo = torch.gather(xp, 1, i - 1)
    f = (i - 1).to(x.dtype) + (xb - lo) / (torch.gather(xp, 1, i) - lo)
    f = torch.where(xb < xp[:, :1], torch.zeros_like(f), f)
    return torch.where(xb > xp[:, -1:], torch.full_like(f, m - 1.0), f)


class GridDistortion(Transform):
    """A.GridDistortion: a per-axis piecewise-linear remap with
    ``num_steps`` cells whose widths are scaled by 1 + U(±limit)."""
    moves_mask = True

    def __init__(self, num_steps: int = 5, distort_limit: float = 0.3):
        self.num_steps, self.distort_limit = num_steps, distort_limit

    def draw(self, gen, n, s, raw_hw=None):
        lim = self.distort_limit
        return {"dx": _uniform(gen, n, -lim, lim, self.num_steps + 1),
                "dy": _uniform(gen, n, -lim, lim, self.num_steps + 1)}

    def _inverse(self, u: torch.Tensor, s: int) -> torch.Tensor:
        """(N, S): the source coordinate of each output index on one
        axis, by inverting the distorted positions of the source pixels."""
        ns = self.num_steps
        cell = s // ns
        steps = 1.0 + u
        widths = float(cell) * steps
        idx = torch.arange(s, device=u.device)
        seg = torch.clamp(idx // cell, max=ns)
        within = (idx - seg * cell).to(torch.float32)
        starts = torch.cat([torch.zeros_like(widths[:, :1]),
                            torch.cumsum(widths, 1)], 1)[:, :ns + 1]
        pos = starts[:, seg] + within * steps[:, seg]
        return _interp_to_index(torch.arange(s, dtype=torch.float32,
                                             device=u.device), pos)

    def coords(self, params: Params, s: int):
        inv_x = self._inverse(params["dx"], s)
        inv_y = self._inverse(params["dy"], s)
        n = inv_x.shape[0]
        return inv_y[:, :, None].expand(n, s, s), \
            inv_x[:, None, :].expand(n, s, s)

    def apply(self, img, mask, params):
        ys, xs = self.coords(params, img.shape[-1])
        return _warp_pair(img, mask, ys, xs, "reflect")


class OpticalDistortion(Transform):
    """A.OpticalDistortion: barrel/pincushion remap
    r → r·(1 + k·r² + k·r⁴) about a shifted centre."""
    moves_mask = True

    def __init__(self, distort_limit: float = 0.5, shift_limit: float = 0.5):
        self.distort_limit, self.shift_limit = distort_limit, shift_limit

    def draw(self, gen, n, s, raw_hw=None):
        dl, sl = self.distort_limit, self.shift_limit
        return {"k": _uniform(gen, n, -dl, dl),
                "dx": _uniform(gen, n, -sl, sl),
                "dy": _uniform(gen, n, -sl, sl)}

    @staticmethod
    def coords(params: Params, s: int):
        kk, dx, dy = (_col(params[k]) for k in ("k", "dx", "dy"))
        f = float(s)
        cx, cy = s / 2.0 + dx, s / 2.0 + dy
        yy, xx = _mesh(s, kk.device)
        xn, yn = (xx - cx) / f, (yy - cy) / f
        r2 = xn * xn + yn * yn
        factor = 1.0 + kk * r2 + kk * r2 * r2
        return yn * factor * f + cy, xn * factor * f + cx

    def apply(self, img, mask, params):
        ys, xs = self.coords(params, img.shape[-1])
        return _warp_pair(img, mask, ys, xs, "reflect")


def _window_coords(oy, cy, ox, cx, s: int):
    """(ys, xs) (N, S, S) that resample the window of cy × cx pixels at
    (oy, ox), all (N,), back to S × S (half-pixel centres)."""
    out = torch.arange(s, dtype=torch.float32, device=oy.device)
    ys = oy[:, None] + ((out + 0.5) * (cy[:, None] / s) - 0.5)
    xs = ox[:, None] + ((out + 0.5) * (cx[:, None] / s) - 0.5)
    n = oy.shape[0]
    return ys[:, :, None].expand(n, s, s), xs[:, None, :].expand(n, s, s)


class RandomCrop(Transform):
    """A.RandomCrop(96, 96), then the dataset's resize back to S
    (forward_selection_integration.py:168-172, dataset.py:50).

    Without raw shapes: a ``crop``² window of the canonical frame at an
    integer offset. With them (the reference's semantics): the 96² raw
    window, ``crop·S/raw`` canonical pixels per axis at a uniform offset:
    a 96² crop of a 1024² raw image is a ~10× zoom, resampled from the
    canonical frame."""
    moves_mask = True

    def __init__(self, crop: int = 96):
        self.crop = crop

    def draw(self, gen, n, s, raw_hw=None):
        if raw_hw is None:
            c = float(min(self.crop, s))
            cy = torch.full((n,), c, device=gen.device)
            oy = _randint(gen, n, 0, s - int(c) + 1).to(torch.float32)
            ox = _randint(gen, n, 0, s - int(c) + 1).to(torch.float32)
            return {"cy": cy, "cx": cy.clone(), "oy": oy, "ox": ox}
        raw = raw_hw.to(torch.float32)
        cy = torch.clamp(self.crop * s / raw[:, 0], 1.0, float(s))
        cx = torch.clamp(self.crop * s / raw[:, 1], 1.0, float(s))
        oy = _uniform(gen, n, 0.0, 1.0) * (s - cy)
        ox = _uniform(gen, n, 0.0, 1.0) * (s - cx)
        return {"cy": cy, "cx": cx, "oy": oy, "ox": ox}

    @staticmethod
    def coords(params: Params, s: int):
        return _window_coords(params["oy"], params["cy"], params["ox"],
                              params["cx"], s)

    def apply(self, img, mask, params):
        ys, xs = self.coords(params, img.shape[-1])
        return _warp_pair(img, mask, ys, xs, "reflect")


class CropAndPad(Transform):
    """A.CropAndPad(percent, reflect, keep_size=True): each side cropped
    (< 0) or padded (> 0) by its own fraction of the frame, then resized
    back."""
    moves_mask = True

    def __init__(self, percent=(-0.1, 0.1)):
        self.percent = percent

    def draw(self, gen, n, s, raw_hw=None):
        # top, right, bottom, left
        return {"sides": _uniform(gen, n, *self.percent, 4)}

    @staticmethod
    def coords(params: Params, s: int):
        top, right, bottom, left = (params["sides"][:, i] * s
                                    for i in range(4))
        y0, y1, x0, x1 = -top, s + bottom, -left, s + right
        out = torch.arange(s, dtype=torch.float32, device=top.device)
        ys = y0[:, None] + (out + 0.5) * (y1 - y0)[:, None] / s - 0.5
        xs = x0[:, None] + (out + 0.5) * (x1 - x0)[:, None] / s - 0.5
        n = top.shape[0]
        return ys[:, :, None].expand(n, s, s), xs[:, None, :].expand(n, s, s)

    def apply(self, img, mask, params):
        ys, xs = self.coords(params, img.shape[-1])
        return _warp_pair(img, mask, ys, xs, "reflect")


# ------------------------------------------------------------- intensity

class GaussNoise(Transform):
    def __init__(self, var_limit=(10.0, 50.0)):
        self.var_limit = var_limit

    def draw(self, gen, n, s, raw_hw=None):
        return {"var": _uniform(gen, n, *self.var_limit),
                "noise": torch.randn((n, s, s), generator=gen,
                                     device=gen.device)}

    def apply(self, img, mask, params):
        noise = params["noise"] * _col(torch.sqrt(params["var"]))
        return torch.clamp(img + noise, 0, 255), mask


class Invert(Transform):
    def apply(self, img, mask, params):
        return 255.0 - img, mask


class Solarize(Transform):
    def __init__(self, threshold: float = 128.0):
        self.threshold = threshold

    def apply(self, img, mask, params):
        return torch.where(img >= self.threshold, 255.0 - img, img), mask


class RandomGamma(Transform):
    def __init__(self, gamma_limit=(80.0, 120.0)):
        self.gamma_limit = gamma_limit

    def draw(self, gen, n, s, raw_hw=None):
        return {"gamma": _uniform(gen, n, *self.gamma_limit)}

    def apply(self, img, mask, params):
        g = _col(params["gamma"]) / 100.0
        return torch.pow(torch.clamp(img / 255.0, 1e-7, 1.0), g) * 255.0, mask


class ColorJitter(Transform):
    """A.ColorJitter(brightness=.2, contrast=.2, saturation=0, hue=0) on
    grayscale: brightness and contrast in a random order (torchvision's
    semantics)."""

    def __init__(self, brightness: float = 0.2, contrast: float = 0.2):
        self.brightness, self.contrast = brightness, contrast

    def draw(self, gen, n, s, raw_hw=None):
        b, c = self.brightness, self.contrast
        return {"b": _uniform(gen, n, 1 - b, 1 + b),
                "c": _uniform(gen, n, 1 - c, 1 + c),
                "brightness_first": _uniform(gen, n, 0.0, 1.0) < 0.5}

    def apply(self, img, mask, params):
        b, c = _col(params["b"]), _col(params["c"])

        def bright(x):
            return torch.clamp(x * b, 0, 255)

        def contr(x):
            mean = x.mean(dim=(-2, -1), keepdim=True)
            return torch.clamp(x * c + mean * (1 - c), 0, 255)

        return torch.where(_col(params["brightness_first"]),
                           contr(bright(img)), bright(contr(img))), mask


# ----------------------------------------------------------- blur / scale

_MAX_K = 7


def _conv2_same_reflect(img: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
    """7×7 'same' cross-correlation with a reflect-101 border
    (cv2.filter2D) of img (N, H, W) with a kernel per image (N, 7, 7):
    49 shifted multiply-adds, in row-major tap order."""
    pad = _MAX_K // 2
    h, w = img.shape[-2:]
    padded = F.pad(img[:, None], (pad,) * 4, mode="reflect")[:, 0]
    out = torch.zeros_like(img)
    for dy in range(_MAX_K):
        for dx in range(_MAX_K):
            out.addcmul_(padded[:, dy:dy + h, dx:dx + w],
                         _col(kernel[:, dy, dx]))
    return out


class AdvancedBlur(Transform):
    """A.AdvancedBlur: a generalised-Gaussian kernel (odd size 3–7,
    anisotropic, rotated, multiplicative noise) embedded in a 7×7 grid
    with the entries outside the drawn size zeroed."""

    def __init__(self, blur_limit=(3, 7), sigmaX=(0.2, 1.0),
                 sigmaY=(0.2, 1.0), rotate_limit: float = 90.0,
                 beta_limit=(0.5, 8.0), noise_limit=(0.9, 1.1)):
        self.blur_limit, self.sigmaX, self.sigmaY = blur_limit, sigmaX, sigmaY
        self.rotate_limit, self.beta_limit = rotate_limit, beta_limit
        self.noise_limit = noise_limit

    def draw(self, gen, n, s, raw_hw=None):
        lo, hi = self.blur_limit
        ksize = lo + 2 * _randint(gen, n, 0, (hi - lo) // 2 + 1)
        sx = _uniform(gen, n, *self.sigmaX)
        sy = _uniform(gen, n, *self.sigmaY)
        rot = _uniform(gen, n, -self.rotate_limit, self.rotate_limit)
        # beta below 1 and above 1 with equal odds
        use_low = _uniform(gen, n, 0.0, 1.0) < 0.5
        beta = torch.where(use_low,
                           _uniform(gen, n, self.beta_limit[0], 1.0),
                           _uniform(gen, n, 1.0, self.beta_limit[1]))
        noise = _uniform(gen, n, *self.noise_limit, _MAX_K, _MAX_K)
        return {"ksize": ksize, "sx": sx, "sy": sy, "rotate": rot,
                "beta": beta, "noise": noise}

    @staticmethod
    def kernel(params: Params) -> torch.Tensor:
        """(N, 7, 7) normalised kernels."""
        sx, sy, beta = (_col(params[k]) for k in ("sx", "sy", "beta"))
        th = _col(torch.deg2rad(params["rotate"]))
        ax = torch.arange(_MAX_K, dtype=torch.float32,
                          device=sx.device) - (_MAX_K - 1) / 2.0
        gy, gx = ax[:, None].expand(_MAX_K, _MAX_K), ax[None, :].expand(
            _MAX_K, _MAX_K)
        rx = gx * torch.cos(th) + gy * torch.sin(th)
        ry = -gx * torch.sin(th) + gy * torch.cos(th)
        d2 = (rx / sx) ** 2 + (ry / sy) ** 2
        kern = torch.exp(-0.5 * torch.pow(d2 + 1e-9, beta))
        half = _col((params["ksize"] - 1) // 2)
        inside = (gx.abs() <= half) & (gy.abs() <= half)
        kern = kern * inside * params["noise"]
        return kern / (kern.sum(dim=(-2, -1), keepdim=True) + 1e-9)

    def apply(self, img, mask, params):
        out = _conv2_same_reflect(img, self.kernel(params))
        return torch.clamp(out, 0, 255), mask


class Downscale(Transform):
    """A.Downscale: the loss of a down- and up-scale, as one resample at
    the low-resolution sample centres. Without raw shapes the low grid has
    S·sc samples across the frame; with them (the reference's semantics)
    raw·sc, so that for a large raw file the later resize averages the
    artefact away."""

    def __init__(self, scale_min: float = 0.5, scale_max: float = 0.75):
        self.scale_min, self.scale_max = scale_min, scale_max

    def draw(self, gen, n, s, raw_hw=None):
        """The factor ``sc`` and the (H, W) it scales: the raw shape, or
        the frame's."""
        sc = _uniform(gen, n, self.scale_min, self.scale_max)
        hw = (torch.full((n, 2), float(s), device=gen.device)
              if raw_hw is None else raw_hw.to(torch.float32))
        return {"sc": sc, "hw": hw}

    @staticmethod
    def coords(params: Params, s: int):
        sc, hw = params["sc"], params["hw"]
        out = torch.arange(s, dtype=torch.float32, device=sc.device)

        def snap(low):
            low = low[:, None]
            pos = torch.floor((out + 0.5) * (low / s))
            pos = torch.minimum(torch.clamp(pos, min=0), low - 1)
            return (pos + 0.5) * (s / low) - 0.5

        ys = snap(torch.floor(hw[:, 0] * sc))
        xs = snap(torch.floor(hw[:, 1] * sc))
        n = ys.shape[0]
        return ys[:, :, None].expand(n, s, s), xs[:, None, :].expand(n, s, s)

    def apply(self, img, mask, params):
        ys, xs = self.coords(params, img.shape[-1])
        return sample_bilinear(img, ys, xs, "reflect"), mask


# ------------------------------------------------------------- dropout

class CoarseDropout(Transform):
    """``min_holes``–``max_holes`` rectangles of min–max size set to
    ``fill_value``."""

    def __init__(self, max_holes: int = 8, max_h: int = 8, max_w: int = 8,
                 min_holes: int = 4, min_h: int = 4, min_w: int = 4,
                 fill_value: float = 0.0):
        self.max_holes, self.max_h, self.max_w = max_holes, max_h, max_w
        self.min_holes, self.min_h, self.min_w = min_holes, min_h, min_w
        self.fill_value = fill_value

    def draw(self, gen, n, s, raw_hw=None):
        m = self.max_holes
        return {"n_holes": _randint(gen, n, self.min_holes, m + 1),
                "h": _randint(gen, n, self.min_h, self.max_h + 1, m),
                "w": _randint(gen, n, self.min_w, self.max_w + 1, m),
                "y0": _randint(gen, n, 0, s - self.min_h + 1, m),
                "x0": _randint(gen, n, 0, s - self.min_w + 1, m)}

    def apply(self, img, mask, params):
        yy, xx = _mesh(img.shape[-1], img.device)
        keep = torch.ones(img.shape, dtype=torch.bool, device=img.device)
        for i in range(self.max_holes):
            y0, x0 = _col(params["y0"][:, i]), _col(params["x0"][:, i])
            hole = ((yy >= y0) & (yy < y0 + _col(params["h"][:, i]))
                    & (xx >= x0) & (xx < x0 + _col(params["w"][:, i])))
            keep &= ~hole | _col(i >= params["n_holes"])
        return torch.where(keep, img, torch.full_like(img, self.fill_value)), \
            mask


class GridDropout(Transform):
    """A grid of square holes (side ``unit·ratio``, at least 1 pixel)
    with a random unit and offset, set to 0."""

    def __init__(self, ratio: float = 0.1, unit_min: int = 4,
                 unit_max: int = 8, random_offset: bool = True):
        self.ratio, self.unit_min, self.unit_max = ratio, unit_min, unit_max
        self.random_offset = random_offset

    def draw(self, gen, n, s, raw_hw=None):
        unit = _randint(gen, n, self.unit_min, self.unit_max + 1)
        if self.random_offset:
            oy = _randint(gen, n, 0, self.unit_max)
            ox = _randint(gen, n, 0, self.unit_max)
        else:
            oy = ox = torch.zeros_like(unit)
        return {"unit": unit, "oy": oy, "ox": ox}

    def apply(self, img, mask, params):
        unit = _col(params["unit"])
        hole = torch.minimum(torch.clamp(
            (unit.to(torch.float32) * self.ratio).to(unit.dtype), min=1),
            unit - 1)
        ar = torch.arange(img.shape[-1], device=img.device)
        iy = (ar[:, None] + _col(params["oy"])) % unit
        ix = (ar[None, :] + _col(params["ox"])) % unit
        drop = (iy < hole) & (ix < hole)
        return torch.where(drop, torch.zeros_like(img), img), mask


# ------------------------------------------------------------- registry

t_horizontal_flip = HorizontalFlip()
t_vertical_flip = VerticalFlip()
t_transpose = Transpose()
t_random_rotate_90 = RandomRotate90()
t_affine = Affine()                       # constant border (production)
t_grid_distortion = GridDistortion()
t_optical_distortion = OpticalDistortion()
t_random_crop = RandomCrop()
t_crop_and_pad = CropAndPad()
t_gauss_noise = GaussNoise()
t_invert = Invert()
t_solarize = Solarize()
t_random_gamma = RandomGamma()
t_color_jitter = ColorJitter()
t_advanced_blur = AdvancedBlur()
t_downscale = Downscale()
t_coarse_dropout = CoarseDropout()
t_grid_dropout = GridDropout()

#: The 18 candidates, names and parameter ranges as in
#: forward_selection_integration.py:71-179.
AUGMENTATION_CANDIDATES: Dict[str, Transform] = {
    "horizontal_flip": t_horizontal_flip,
    "affine": Affine(border="reflect"),
    "random_rotate_90": t_random_rotate_90,
    "transpose": t_transpose,
    "grid_distortion": t_grid_distortion,
    "vertical_flip": t_vertical_flip,
    "optical_distortion": t_optical_distortion,
    "gauss_noise": t_gauss_noise,
    "invert": t_invert,
    "solarize": t_solarize,
    "random_gamma": t_random_gamma,
    "color_jitter": t_color_jitter,
    "advanced_blur": t_advanced_blur,
    "downscale": t_downscale,
    "coarse_dropout": t_coarse_dropout,
    "grid_dropout": t_grid_dropout,
    "random_crop": t_random_crop,
    "crop_and_pad": t_crop_and_pad,
}

#: Transforms whose reference semantics act on the raw (pre-resize) image
#: with pixel-unit parameters (random_crop crops 96² of the raw file,
#: forward_selection_integration.py:168-172; downscale's factor applies to
#: the raw resolution).
RAW_FRAME_AWARE = frozenset({"random_crop", "downscale"})


def production_probability(name: str) -> float:
    """Per-transform production probabilities
    (forward_selection_integration.py:255-264)."""
    if name in ("horizontal_flip", "vertical_flip"):
        return 0.5
    if name == "clahe":
        return 0.7
    return 0.3


# Images per apply call of ``Pipeline.augment_u8``: bounds the gather
# indices and the rotations' stack (~1 GB at 512²).
APPLY_CHUNK = 64


class Pipeline:
    """A probability-gated chain of transforms.

    ``steps``: (transform, p) or (transform, p, raw_aware). Each step
    draws a gate U < p and its parameters for every image (``draw``),
    then ``apply`` applies it where the gate is open. Raw-frame-aware
    steps get the images' raw shapes when the caller gives them."""

    def __init__(self, steps: Sequence[Tuple]):
        self.steps = [tuple(s) if len(s) == 3 else (*s, False)
                      for s in steps]

    def draw(self, gen: torch.Generator, n: int, s: int,
             raw_hw: Optional[torch.Tensor] = None
             ) -> List[Tuple[torch.Tensor, Params]]:
        out = []
        for t, p, raw_aware in self.steps:
            gate = _uniform(gen, n, 0.0, 1.0) < p
            out.append((gate, t.draw(gen, n, s, raw_hw if raw_aware
                                     else None)))
        return out

    def apply(self, img, mask, draws):
        for (t, _, _), (gate, params) in zip(self.steps, draws):
            ni, nm = t.apply(img, mask, params)
            g = _col(gate)
            img, mask = torch.where(g, ni, img), torch.where(g, nm, mask)
        return img, mask

    def augment_u8(self, images_u8: torch.Tensor, masks_u8: torch.Tensor,
                   gen: torch.Generator, raw_hw=None,
                   label_mask: bool = False):
        """The uint8 contract (dataset.py:156-202): images as float32 in
        [0, 255], binary masks scaled by 255 and thresholded at > 127
        (label masks, ``label_mask``: class labels kept and rounded), the
        output rounded as floor(clip + 0.5). (N, S, S) uint8 in and out,
        on ``gen``'s device, in chunks of ``APPLY_CHUNK`` images."""
        if label_mask and raw_hw is not None:
            raise ValueError("label_mask is the production (canonical-frame)"
                             " path; raw-frame semantics are forward-"
                             "selection/binary only")
        n, s = images_u8.shape[0], images_u8.shape[-1]
        if raw_hw is not None:
            raw_hw = torch.as_tensor(raw_hw, device=gen.device)
        draws = self.draw(gen, n, s, raw_hw)
        outs_i, outs_m = [], []
        for a in range(0, n, APPLY_CHUNK):
            sl = slice(a, a + APPLY_CHUNK)
            part = [(g[sl], {k: v[sl] for k, v in p.items()})
                    for g, p in draws]
            img = images_u8[sl].to(torch.float32)
            mask = masks_u8[sl].to(torch.float32) * (1.0 if label_mask
                                                     else 255.0)
            ai, am = self.apply(img, mask, part)
            outs_i.append(torch.floor(torch.clamp(ai, 0, 255) + 0.5)
                          .to(torch.uint8))
            outs_m.append((torch.floor(am + 0.5) if label_mask
                           else am > 127.0).to(torch.uint8))
        return torch.cat(outs_i), torch.cat(outs_m)


def build_pipeline(names: Sequence[str], for_selection: bool = True
                   ) -> Pipeline:
    """Candidates by name, gated at p = 0.7 each (selection mode) or at
    their production probabilities
    (forward_selection_integration.py:238-268)."""
    return Pipeline([(AUGMENTATION_CANDIDATES[name],
                      0.7 if for_selection else production_probability(name),
                      name in RAW_FRAME_AWARE) for name in names])


@functools.lru_cache(maxsize=1)
def _production_pipeline() -> Pipeline:
    """The production augmenter (dataset.py:148-154): RandomRotate90
    p=.5, Affine (constant border) p=.3, VerticalFlip p=.5, AdvancedBlur
    (3–7) p=.3."""
    return Pipeline([(t_random_rotate_90, 0.5), (t_affine, 0.3),
                     (t_vertical_flip, 0.5), (t_advanced_blur, 0.3)])


def augment_batch(images_u8, masks_u8, generator: torch.Generator,
                  pipeline, copies: int, raw_hw=None,
                  label_mask: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``copies`` augmented versions of every canonical frame: (N, S, S)
    uint8 images and {0, 1} masks → (copies·N, S, S) each, copy-major, on
    ``generator``'s device. ``pipeline``: a ``Pipeline``, one
    ``Transform`` (always applied) or None (identity). ``raw_hw`` (N, 2):
    the raw shapes, for the raw-frame-aware steps of a ``Pipeline``."""
    if isinstance(pipeline, Transform):
        if raw_hw is not None:
            raise ValueError(
                "augment_batch: raw_hw requires a Pipeline; a bare "
                "transform runs with canonical-frame semantics and would "
                "ignore the raw shapes. Build a Pipeline([...]) with "
                "raw-aware steps instead.")
        pipeline = Pipeline([(pipeline, 1.0)])
    elif pipeline is None:
        pipeline = Pipeline([])
    dev = generator.device
    images_u8 = torch.as_tensor(images_u8).to(dev)
    masks_u8 = torch.as_tensor(masks_u8).to(dev)
    outs = [pipeline.augment_u8(images_u8, masks_u8, generator, raw_hw,
                                label_mask) for _ in range(copies)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


class CellAugmenter:
    """Production augmenter (reference: CellAugmenter, dataset.py:140-210):
    ``augmentations_per_image`` augmented copies of every training image,
    originals kept, as device tensors on ``device`` (default ``cuda``;
    raises without it unless ``device='cpu'``) instead of temp files, so
    ``cleanup()`` has nothing to do."""

    def __init__(self, augmentations_per_image: int = 3, seed: int = 0,
                 n_classes: int = 1, *, device="cuda"):
        self.augmentations_per_image = int(augmentations_per_image)
        self.device = resolve_device(device)
        self._pipeline = _production_pipeline()
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._label_mask = int(n_classes) > 1

    def augment_training_data(self, images_u8, masks_u8
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, S, S) canonical uint8 images and masks → the originals,
        then the N·copies augmented frames (dataset.py:156-202)."""
        images_u8 = torch.as_tensor(images_u8).to(self.device)
        masks_u8 = torch.as_tensor(masks_u8).to(self.device)
        if self.augmentations_per_image == 0:
            return images_u8, masks_u8
        ai, am = augment_batch(images_u8, masks_u8, self._gen,
                               self._pipeline, self.augmentations_per_image,
                               label_mask=self._label_mask)
        n0 = images_u8.shape[0]
        print(f"Training data: {n0} original + {ai.shape[0]} augmented = "
              f"{n0 + ai.shape[0]} total")
        return torch.cat([images_u8, ai]), torch.cat([masks_u8, am])

    def cleanup(self):  # API parity (dataset.py:204-207); nothing on disk
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cleanup()
        return False
