"""The reference's serving paths: the poses the timed path should have
served, worked out again from the raw requests and the weights.

Plain float32 with TF32 off (the caller sets the flags). Requests are built,
routed and collated by the reference's own copies; each batch runs the
reference model. `dock_raw` gives each request's pose as the engine's
`dock_raw` unpacks it (ligand atoms plus the protein's mean, the world
frame). `dock_raw_forced` docks at given pocket centers and crops.
`fp8_storage` stores every tensor of the reference in float8 (e4m3, one
scale per tensor): the lower-precision control.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from benchmark.reference.batching import build_sample, collate
from benchmark.reference.buckets import route_sample
from benchmark.reference.models.fabind import make_model
from benchmark.reference.types import FABindBatch

Tensor = torch.Tensor


def full_precision() -> None:
    """float32 products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(cfg, state_dict: Dict[str, Tensor], device):
    """The reference model in float32 on `device` with these weights."""
    model = make_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device=device, dtype=torch.float32).eval()


def routed_batches(raws: Sequence[Dict], bucket_cfgs, batch_size: int
                   ) -> Iterator[Tuple[list, object, Dict, int]]:
    """(chunk [(request index, sample)...], bucket cfg, host arrays, real
    rows), in the engine's order: buckets in the order their first request
    arrives, chunks of batch_size, the last row repeated as padding."""
    by_bucket: Dict[int, Tuple[object, list]] = {}
    for pos, raw in enumerate(raws):
        s = build_sample(raw, bucket_cfgs[-1], group="test")
        c = route_sample(s, bucket_cfgs)
        if c is None:
            raise ValueError(f"request {pos} fits no bucket")
        by_bucket.setdefault(id(c), (c, []))[1].append((pos, s))
    for c, items in by_bucket.values():
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            ss = [s for _, s in chunk]
            ss += [ss[-1]] * (batch_size - len(ss))
            yield chunk, c, collate(ss, c, n_valid=len(chunk)), len(chunk)


def to_batch(arrays: Dict, device) -> FABindBatch:
    return FABindBatch.from_numpy(arrays, device)


def dock_raw(model, raws: Sequence[Dict], bucket_cfgs, batch_size: int,
             device) -> List[np.ndarray]:
    """The world-frame pose [n_atoms, 3] of every request."""
    out: List = [None] * len(raws)
    with torch.inference_mode():
        for chunk, c, arrays, n_real in routed_batches(raws, bucket_cfgs,
                                                       batch_size):
            coords = model.inference_diag(to_batch(arrays, device),
                                          shapes=c.shapes)[0]
            lig = coords.float().cpu().numpy()
            for b in range(n_real):
                pos, s = chunk[b]
                n = s["lig_feat"].shape[0]
                out[pos] = lig[b, :n] + s["coord_offset"]
    return out


def dock_raw_forced(model, raws: Sequence[Dict], bucket_cfgs,
                    batch_size: int, device, centers: Dict[int, np.ndarray]
                    = None, crops: Dict[int, np.ndarray] = None
                    ) -> List[Dict]:
    """dock_raw at given pocket centers: per request {"coords": world-frame
    pose, "center": the center it docked at (protein-mean frame), ...}.
    `centers` maps a request's index to the center it is docked at (the
    program's); None docks each at its own rounded center. `crops` maps
    it to the residues of its pocket crop (the program's, in slot order);
    None crops around the center. Each also carries the pocket stage's
    logits [Nr], the residue coordinates [Nr, 3] it read and its crop."""
    from benchmark.reference.ops.gumbel import pocket_center_rounded
    out: List = [None] * len(raws)
    with torch.inference_mode():
        for chunk, c, arrays, n_real in routed_batches(raws, bucket_cfgs,
                                                       batch_size):
            batch = to_batch(arrays, device)
            pocket = model._pocket_pred(batch, c.shapes)
            m = bucket_cfgs[-1].model
            own = pocket_center_rounded(pocket[2], batch.prot_xyz,
                                        batch.prot_mask, m.gs_tau, m.gs_hard)
            ctr = own
            rows = [chunk[min(b, n_real - 1)][0] for b in range(batch_size)]
            if centers is not None:
                ctr = torch.as_tensor(np.stack([centers[r] for r in rows]),
                                      dtype=own.dtype, device=device)
            if crops is None:
                idx, mask, _, _ = model._predicted_crop(
                    ctr, batch, c.shapes, model._crop_radius(pocket[3]))
            else:
                idx = torch.zeros(batch_size, c.shapes.max_pocket,
                                  dtype=torch.long)
                for b, r in enumerate(rows):
                    idx[b, :len(crops[r])] = torch.as_tensor(crops[r])
                mask = (torch.arange(c.shapes.max_pocket)[None]
                        < torch.tensor([len(crops[r]) for r in rows])[:, None])
                idx, mask = idx.to(device), mask.to(device)
            coords = model._dock(batch, pocket[0], pocket[1], idx, mask, True,
                                 c.shapes.ctx_k)[0]
            lig = coords.float().cpu().numpy()
            crop = [i[m].tolist() for i, m in zip(idx.cpu().numpy(),
                                                   mask.cpu().numpy())]
            logits = pocket[2].float().cpu().numpy()
            xyz = batch.prot_xyz.float().cpu().numpy()
            ctr = ctr.float().cpu().numpy()
            for b in range(n_real):
                pos, s = chunk[b]
                n, nr = s["lig_feat"].shape[0], s["prot_xyz"].shape[0]
                out[pos] = {"coords": lig[b, :n] + s["coord_offset"],
                            "logits": logits[b, :nr], "xyz": xyz[b, :nr],
                            "center": ctr[b], "crop": crop[b]}
    return out


def rounded_center(logits: np.ndarray, xyz: np.ndarray, m,
                   dtype=torch.float32) -> np.ndarray:
    """The center the reference's `pocket_center_rounded` computes in
    `dtype` (the program's: a bfloat16 sigmoid rounds values near 0.5 to
    0.5) from given logits [Nr] and coordinates [Nr, 3] (a request's valid
    residues) with model config m."""
    from benchmark.reference.ops.gumbel import pocket_center_rounded
    lg = torch.as_tensor(np.asarray(logits, np.float32))[None].to(dtype)
    c = pocket_center_rounded(lg, torch.as_tensor(
        np.asarray(xyz, np.float32))[None].to(dtype),
        torch.ones(lg.shape, dtype=torch.bool), m.gs_tau, m.gs_hard)
    return c[0].float().numpy()


def crop_of(center: np.ndarray, xyz: np.ndarray, model, max_pocket: int,
            dtype=torch.float32, radius=None) -> List[int]:
    """The residues the reference's `_predicted_crop` keeps around a given
    center from coordinates [Nr, 3], computed in `dtype` (the program's)."""
    from types import SimpleNamespace
    x = torch.as_tensor(np.asarray(xyz, np.float32))[None].to(dtype)
    b = SimpleNamespace(prot_xyz=x, prot_mask=torch.ones(x.shape[:2],
                                                         dtype=torch.bool))
    shapes = SimpleNamespace(max_pocket=max_pocket)
    c = torch.as_tensor(np.asarray(center, np.float32))[None].to(dtype)
    idx, mask, _, _ = model._predicted_crop(c, b, shapes, radius)
    return idx[0][mask[0]].tolist()


@contextlib.contextmanager
def recording_crops(model) -> Iterator[List]:
    """Record each (prot_xyz, idx, mask) of `model._predicted_crop` (an
    instance's method, wrapped on the instance for the block; copies on
    the device, read after it)."""
    log: List = []
    fn = model._predicted_crop

    def logged(center, batch, shapes, radius=None):
        out = fn(center, batch, shapes, radius)
        log.append(tuple(t.detach().clone()
                         for t in (batch.prot_xyz, out[0], out[1])))
        return out

    model._predicted_crop = logged
    try:
        yield log
    finally:
        del model._predicted_crop


@contextlib.contextmanager
def recording_centers(module) -> Iterator[List]:
    """Record, in call order, each (cls_logits, prot_xyz, prot_mask,
    center) of `module.pocket_center_rounded` (copies on the device, read
    after the block: nothing waits for the device inside it)."""
    log: List = []
    fn = module.pocket_center_rounded

    def logged(cls_logits, coords, mask, tau, hard):
        center = fn(cls_logits, coords, mask, tau, hard)
        log.append(tuple(t.detach().clone()
                         for t in (cls_logits, coords, mask, center)))
        return center

    module.pocket_center_rounded = logged
    try:
        yield log
    finally:
        module.pocket_center_rounded = fn


def _fp8(t: Tensor) -> Tensor:
    """t rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude to 448), back in t's dtype."""
    amax = t.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return t
    s = 448.0 / amax
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)


class _Fp8Storage(TorchDispatchMode):
    """Every floating-point result of every operator rounded to float8
    (views and in-place operators keep their aliasing and are left
    alone)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if func.is_view or name.endswith("_") or "out" in (kwargs or {}):
            return out
        return tree_map(lambda x: _fp8(x) if isinstance(x, Tensor)
                        and x.is_floating_point() else x, out)


@contextlib.contextmanager
def fp8_storage(model) -> Iterator[None]:
    """The reference one precision below the served bfloat16: its weights,
    the batch it reads and every tensor it computes stored in float8 (e4m3,
    one scale per tensor), as the bfloat16 engine stores them in bfloat16;
    each operator still computes in float32. The weights are restored
    after the block."""
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for v in model.state_dict().values():
            if v.is_floating_point():
                v.copy_(_fp8(v))
    try:
        with _Fp8Storage():
            yield
    finally:
        model.load_state_dict(saved)
