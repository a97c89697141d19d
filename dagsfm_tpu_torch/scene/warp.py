"""Image warping between camera models and by homographies.

Port of dagsfm_tpu/scene/warp.py: `warp_image_between_cameras` (resample
an image so it looks as if taken by another camera with the same pose),
`warp_image_with_homography` and `resample_image_bilinear`. Each is one
batch of tensor ops on the image's device, in the image's dtype.

`resample_image_bilinear` is `jax.image.resize(..., "bilinear")`, which
antialiases: when it shrinks an axis, the triangle kernel widens by the
shrink factor (upsampling only interpolates). `F.interpolate` does not
do that, so the port builds the same per-axis weight matrices and
contracts the image with them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cameras as cm


def _bilinear(img: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) or (H, W, C) at float coords; 0 outside."""
    H, W = img.shape[:2]
    xi = torch.clamp(torch.floor(x).long(), 0, W - 2)
    yi = torch.clamp(torch.floor(y).long(), 0, H - 2)
    # fractions relative to the clipped base, so x = W - 1 samples
    # img[., W - 1]
    fx = torch.clamp(x - xi.to(x.dtype), 0.0, 1.0)
    fy = torch.clamp(y - yi.to(y.dtype), 0.0, 1.0)
    v00 = img[yi, xi]
    v01 = img[yi, xi + 1]
    v10 = img[yi + 1, xi]
    v11 = img[yi + 1, xi + 1]
    ok = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    if img.dim() == 3:
        fx, fy, ok = fx[..., None], fy[..., None], ok[..., None]
    v = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
         + v10 * fy * (1 - fx) + v11 * fy * fx)
    return torch.where(ok, v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def warp_image_with_homography(img: torch.Tensor, H,
                               out_shape: tuple | None = None
                               ) -> torch.Tensor:
    """out(x) = img(H @ x)."""
    Ho, Wo = out_shape if out_shape is not None else img.shape[:2]
    dt, dev = img.dtype, img.device
    ys, xs = torch.meshgrid(torch.arange(Ho, dtype=dt, device=dev),
                            torch.arange(Wo, dtype=dt, device=dev),
                            indexing="ij")
    p = torch.stack([xs, ys, torch.ones_like(xs)])
    q = torch.einsum("ij,jhw->ihw", torch.as_tensor(H, dtype=dt,
                                                    device=dev), p)
    z = torch.where(torch.abs(q[2]) < 1e-12,
                    torch.full_like(q[2], 1e-12), q[2])
    return _bilinear(img, q[1] / z, q[0] / z)


def warp_image_between_cameras(src_cam: cm.Camera, dst_cam: cm.Camera,
                               img: torch.Tensor) -> torch.Tensor:
    """Resample `img` (taken by src_cam) as dst_cam with the same pose
    sees it: every target pixel is lifted to the normalized plane with the
    target model, projected with the source model and sampled
    bilinearly."""
    Ho = int(dst_cam.height) or img.shape[0]
    Wo = int(dst_cam.width) or img.shape[1]
    dt, dev = img.dtype, img.device
    ys, xs = np.meshgrid(np.arange(Ho), np.arange(Wo), indexing="ij")
    pix = torch.as_tensor(np.stack([xs, ys], -1).reshape(-1, 2), dtype=dt,
                          device=dev)
    uv = cm.cam_from_img(dst_cam.model_id, _params(dst_cam, dt, dev), pix)
    xyz = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    sp = cm.img_from_cam(src_cam.model_id, _params(src_cam, dt, dev), xyz)
    sp = sp.reshape(Ho, Wo, 2)
    return _bilinear(img, sp[..., 1], sp[..., 0])


def _params(cam: cm.Camera, dtype, device) -> torch.Tensor:
    return cm.pad_params(cam.params, cam.model_id).to(dtype=dtype,
                                                      device=device)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) float64 weights of jax.image's antialiased triangle
    kernel (scale n_out / n_in, no translation)."""
    dtype = torch.float64
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(n_out, dtype=dtype, device=device) + 0.5)
                * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=dtype, device=device)[:, None]) / kernel_scale
    w = torch.clamp(1 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(
        np.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resample_image_bilinear(img: torch.Tensor, new_h: int,
                            new_w: int) -> torch.Tensor:
    """(H, W[, C]) -> (new_h, new_w[, C]) as jax.image.resize's
    antialiased bilinear resize."""
    out = img
    for axis, n_out in ((0, new_h), (1, new_w)):
        n_in = img.shape[axis]
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, n_out, img.device).to(img.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([axis], [0])),
                            -1, axis)
    return out
