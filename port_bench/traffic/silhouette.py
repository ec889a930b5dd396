"""Training batches: a rectified stereo pair of a capsule silhouette with
flow targets, and (for stage 2) a novel view between the two source cameras
with its target image.

Frozen from gps_gaussian_tpu_torch/testing.py at commit 19aea69
(`silhouette_stereo_batch`, `silhouette_train_batch`): the same cameras,
silhouette and value ranges, with the random images, flows and targets
drawn by a torch.Generator on the run's device instead of numpy on the host.
A mix file (traffic/<name>.json) sets:

    pool       batches made at set-up and cycled by the window (all differ)
    batch      samples per batch
    res        source width and height
    novel_res  novel target width and height (0: no novel view, stage 1)
    fg_frac    share of each source view the silhouette covers

The cameras sit 0.2 apart on x, looking down +z; each view's principal
point is offset from the other's by d = 0.05 * res pixels and
tf_x = -+2d, so zero flow maps the silhouette to inverse depth 0.5.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import cameras


def _silhouette(res: int, fg_frac: float) -> np.ndarray:
    v = (np.arange(res, dtype=np.float32) + 0.5) / res
    w_amp = (fg_frac - 0.025) * np.pi / 2.0
    half = 0.0125 + w_amp * np.sin(np.pi * v) / 2.0
    return (np.abs(v[None, :] - 0.5) < half[:, None]).astype(np.float32)


def make_batch(mix: dict, gen: torch.Generator, device) -> dict:
    """One batch as nested dicts of tensors on `device`: lmain / rmain with
    img, mask, intr, ref_intr, extr, tf_x, flow, valid; and, when the mix
    has a novel view, novel with camera (view, proj, cam_center, tanfovx,
    tanfovy), img, intr, extr, height, width."""
    b, res = mix["batch"], mix["res"]
    mask = torch.as_tensor(_silhouette(res, mix["fg_frac"]), device=device)
    m = mask[None, :, :, None].expand(b, res, res, 1).contiguous()
    d = 0.05 * res
    f = 0.8 * res

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def view(cx, ref_cx, tx, tf_x):
        K = np.array([[f, 0, cx], [0, f, res / 2], [0, 0, 1]], np.float32)
        K_ref = K.copy()
        K_ref[0, 2] = ref_cx
        E = np.eye(3, 4, dtype=np.float32)
        E[0, 3] = tx

        def tile(a):
            return torch.as_tensor(np.tile(a, (b, 1, 1)), device=device)
        return {"img": (rand(b, res, res, 3) * 2 - 1) * m, "mask": m,
                "intr": tile(K), "ref_intr": tile(K_ref), "extr": tile(E),
                "tf_x": torch.full((b,), tf_x, device=device),
                "flow": (rand(b, res, res, 1) * 4 - 2) * m, "valid": m}, K, E

    left, K0, E0 = view(res / 2, res / 2 + d, 0.1, -2.0 * d)
    right, K1, E1 = view(res / 2 + d, res / 2, -0.1, 2.0 * d)
    out = {"lmain": left, "rmain": right}
    nres = mix.get("novel_res", 0)
    if nres:
        cam, intr, extr = cameras.interpolated_novel_camera(
            K0, E0, K1, E1, 0.5, nres, nres, hr_scale=nres / res)
        stack = {k: torch.as_tensor(np.stack([cam[k]] * b), device=device)
                 for k in cam}
        out["novel"] = {
            "camera": stack, "img": rand(b, nres, nres, 3),
            "intr": torch.as_tensor(np.tile(intr.astype(np.float32),
                                            (b, 1, 1)), device=device),
            "extr": torch.as_tensor(np.tile(extr.astype(np.float32),
                                            (b, 1, 1)), device=device),
            "height": nres, "width": nres}
    return out


def make_pool(mix: dict, seed: int, device) -> list:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [make_batch(mix, gen, device) for _ in range(mix["pool"])]
