"""FABind+ confidence-head training.

Own copy of fabind_tpu/train/confidence.py. The regression model is frozen
but for its confidence head (the `ranking*`/`confidence*` parameters); each
complex runs `cfg.train.num_copies` stochastic forwards ("copies") and a
pairwise ranking loss orders the copies' confidence scores by their RMSD to
the crystal pose (`losses.confidence_ranking_loss`).

Two copy sources:
- "teacher" (the reference's mechanics): teacher-forced training forwards,
  dropout the only difference between copies;
- "inference": stochastic inference passes, each from its own randomized
  ligand start and pocket center (`sample_copy_inputs`), the pose
  population the head ranks when it is deployed.

cfg.train.ranking_pair_scope "within" (the reference protocol) pairs copies
of one complex only; "global" pairs every copy of the batch.

The trunk's parameters have requires_grad False, so autograd records only
the head: each copy keeps the graph of the head alone, and the trunk's
backward never runs. The copies run one after the other, as the JAX step
maps over them. The step runs in float32; there is no bf16 path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.data.batching import uniform_random_rotation
from fabind_tpu_torch.data.torsion import randomize_torsions
from fabind_tpu_torch.data.types import FABindBatch, to_device
from fabind_tpu_torch.models.layers import dropout_rng
from fabind_tpu_torch.ops.gumbel import pocket_center_rounded
from fabind_tpu_torch.sample import dbscan_clusters, pick_cluster_centers
from fabind_tpu_torch.train.checkpoints import HEAD_PREFIXES
from fabind_tpu_torch.train.losses import confidence_ranking_loss

Tensor = torch.Tensor
METRIC_KEYS = ("confidence_loss", "ranking_accuracy",
               "ranking_accuracy_global", "ranking_accuracy_within",
               "hit_rate", "chosen_rmsd_lt2", "best_rmsd_lt2")


def build_confidence_optimizer(cfg: FABindConfig, model: torch.nn.Module
                               ) -> torch.optim.Adam:
    """Freeze the trunk (requires_grad False) and return Adam at
    cfg.train.lr over the confidence head, optax.adam's formula (see
    postopt.post_optimize_batch)."""
    head = []
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith(HEAD_PREFIXES))
        if p.requires_grad:
            head.append(p)
    if not head:
        raise ValueError("the model has no confidence head; build it with "
                         "confidence_training=True")
    return torch.optim.Adam(head, lr=cfg.train.lr, betas=(0.9, 0.999),
                            eps=1e-8)


def copy_generators(generator: torch.Generator, n_copies: int, device
                    ) -> List[torch.Generator]:
    """One dropout generator on `device` per copy, seeded from draws of the
    host `generator` (one step's draws; the JAX step splits its key)."""
    seeds = torch.randint(0, 2 ** 62, (n_copies,), generator=generator)
    return [torch.Generator(device).manual_seed(int(s)) for s in seeds]


def _copies_teacher(model, batch: FABindBatch, gens, shapes, init_coords,
                    centers) -> Tuple[Tensor, Tensor]:
    """[C]-stacked teacher-forced training forwards, copy c inside
    dropout_rng(gens[c])."""
    coords, scores = [], []
    for g in gens:
        with dropout_rng(g):
            out = model(batch, train=True, shapes=shapes)
        coords.append(out.coords)
        scores.append(out.confidence)
    return torch.stack(coords), torch.stack(scores)


def _copies_inference(model, batch: FABindBatch, gens, shapes,
                      init_coords: Tensor, centers: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """[C]-stacked stochastic inference passes: copy c starts the ligand
    at init_coords[c] [B, Nc, 3] and crops around centers[c] [B, 3]."""
    coords, scores = [], []
    for g, init, center in zip(gens, init_coords, centers):
        b = dataclasses.replace(batch, lig_coords_init=init)
        with dropout_rng(g):
            c, conf, _ = model.inference_diag(b, center_override=center,
                                              shapes=shapes)
        coords.append(c)
        scores.append(conf)
    return torch.stack(coords), torch.stack(scores)


def _copy_source(pose_source: str) -> Callable:
    if pose_source == "teacher":
        return _copies_teacher
    if pose_source == "inference":
        return _copies_inference
    raise ValueError(f"pose_source {pose_source!r}")


def rmsd_per_copy(coords: Tensor, gt: Tensor, mask: Tensor) -> Tensor:
    """[C, B] RMSD of copies [C, B, Nc, 3] to gt [B, Nc, 3] over mask."""
    m = mask.to(coords.dtype)
    sd = ((coords - gt) ** 2).sum(-1)
    return torch.sqrt((sd * m).sum(-1) / m.sum(-1).clamp(min=1.0))


def _as_device(x: Optional[np.ndarray], device) -> Optional[Tensor]:
    """A host array from `sample_copy_inputs` as a float32 tensor on
    `device`."""
    if x is None:
        return None
    return to_device(torch.from_numpy(np.ascontiguousarray(x, np.float32)),
                     device)


def _loss_and_metrics(cfg: FABindConfig, batch: FABindBatch, scores: Tensor,
                      rmsds: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The ranking loss of scores [C, B] against rmsds [C, B] and the JAX
    step's metrics, as tensors."""
    C, B = scores.shape
    svf = (batch.sample_valid.float() if batch.sample_valid is not None
           else torch.ones(B, device=scores.device))
    nsv = svf.sum().clamp(min=1.0)
    flat_s, flat_r = scores.reshape(-1), rmsds.reshape(-1)
    flat_v = svf.expand(C, B).reshape(-1) > 0
    scope = cfg.train.ranking_pair_scope
    if scope == "within":
        groups = torch.arange(B, device=scores.device).expand(C, B).reshape(-1)
    elif scope == "global":
        groups = None
    else:
        raise ValueError(f"ranking_pair_scope: {scope!r}")
    loss = confidence_ranking_loss(
        flat_s, flat_r, valid=flat_v, loss_type=cfg.train.ranking_loss,
        keep_cls_2a=cfg.train.keep_cls_2A, groups=groups)
    with torch.no_grad():
        s = scores.detach()
        fs = flat_s.detach()
        # pair accuracy over every pair of the batch (cross-complex too)
        fb = ((flat_r[:, None] < flat_r[None, :])
              & flat_v[:, None] & flat_v[None, :]).float()
        acc_global = (((fs[:, None] > fs[None, :]).float() * fb).sum()
                      / fb.sum().clamp(min=1.0))
        # per complex: pair accuracy over its copies sorted by RMSD, and
        # whether its best copy outscores all the others
        ss = s.gather(0, rmsds.argsort(dim=0, stable=True))   # [C, B]
        i = torch.arange(C, device=s.device)
        upper = (i[None, :] > i[:, None]).float()         # j worse than i
        correct = (ss[:, None, :] > ss[None, :, :]).float() * upper[..., None]
        accs = correct.sum((0, 1)) / upper.sum().clamp(min=1.0)
        hits = (ss[0] > ss[1:].max(0).values).float()
        chosen = rmsds[s.argmax(0), torch.arange(B, device=s.device)]
        best = rmsds.min(0).values
        acc_within = (accs * svf).sum() / nsv
        metrics = {
            "confidence_loss": loss.detach(),
            "ranking_accuracy": (acc_within if scope == "within"
                                 else acc_global),
            "ranking_accuracy_global": acc_global,
            "ranking_accuracy_within": acc_within,
            "hit_rate": (hits * svf).sum() / nsv,
            "chosen_rmsd_lt2": ((chosen < 2).float() * svf).sum() / nsv,
            "best_rmsd_lt2": ((best < 2).float() * svf).sum() / nsv,
        }
    return loss, metrics


def make_confidence_train_step(model, cfg: FABindConfig, optimizer,
                               pose_source: str = "teacher") -> Callable:
    """One step over a batch of complexes, each with cfg.train.num_copies
    stochastic forwards:

        step(batch, generator, init_coords=None, centers=None, shapes=None)
            -> {metric: float}

    `generator` (host) seeds the copies' dropout generators; "inference"
    copies need init_coords [C, B, Nc, 3] and centers [C, B, 3] (host
    arrays from `sample_copy_inputs`). `shapes` is the batch's
    bucket (default the model's). The loss is the ranking loss
    (confidence_loss); the metrics are read back to the host once."""
    n_copies = cfg.train.num_copies
    if n_copies < 2:
        raise ValueError("confidence ranking needs num_copies >= 2")
    gen_copies = _copy_source(pose_source)

    def step(batch: FABindBatch, generator: torch.Generator,
             init_coords=None, centers=None, shapes=None) -> Dict[str, float]:
        device = batch.lig_coords.device
        optimizer.zero_grad(set_to_none=True)
        coords, scores = gen_copies(
            model, batch, copy_generators(generator, n_copies, device),
            shapes, _as_device(init_coords, device),
            _as_device(centers, device))
        rmsds = rmsd_per_copy(coords.detach(), batch.lig_coords,
                              batch.lig_mask)
        loss, metrics = _loss_and_metrics(cfg, batch, scores, rmsds)
        loss.backward()
        optimizer.step()
        vals = torch.stack([metrics[k] for k in METRIC_KEYS]).cpu()
        return dict(zip(METRIC_KEYS, vals.double().tolist()))

    return step


def randomized_init_copies(batch: FABindBatch, n_copies: int,
                           rng: np.random.RandomState) -> np.ndarray:
    """[C, B, Nc, 3] per-copy ligand starts: every rotatable torsion set at
    random, then a uniform random rotation about the start's centroid. The
    bonds come from the batch's bond table. Host numpy, with the JAX
    package's draws from `rng`."""
    init = batch.lig_coords_init.float().cpu().numpy()
    mask = batch.lig_mask.cpu().numpy().astype(bool)
    bond_idx = batch.bond_idx.cpu().numpy()
    bond_mask = batch.bond_mask.cpu().numpy().astype(bool)
    B = init.shape[0]
    out = np.tile(init[None], (n_copies, 1, 1, 1))
    for b in range(B):
        n = int(mask[b].sum())
        if n < 2:
            continue
        ii, _ = np.nonzero(bond_mask[b, :n])
        jj = bond_idx[b, :n][bond_mask[b, :n]]
        keep = jj < n
        edges = np.unique(np.sort(np.stack(
            [ii[keep], jj[keep]], axis=1), axis=1), axis=0)
        c = init[b, :n].mean(0, keepdims=True)
        for s in range(n_copies):
            rand = randomize_torsions(init[b, :n], edges, rng)
            out[s, b, :n] = uniform_random_rotation(rand, rng) + c
    return out


def sample_copy_inputs(model, batch: FABindBatch, cfg: FABindConfig,
                       n_copies: int, rng: np.random.RandomState,
                       use_clustering: bool = True, shapes=None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Host (init_coords [C, B, Nc, 3], centers [C, B, 3]) for the
    "inference" copy source: the deterministic pocket stage's rounded
    center, or with `use_clustering` a DBSCAN cluster's mean picked at
    random per copy (`sample.pick_cluster_centers`), and torsion- and
    orientation-randomized starts (`randomized_init_copies`), in the JAX
    package's order of draws from `rng`."""
    m = cfg.model
    model.eval()
    with torch.inference_mode():
        _, _, cls_logits, _ = model._pocket_pred(batch, shapes or cfg.shapes)
        default = pocket_center_rounded(
            cls_logits, batch.prot_xyz, batch.prot_mask, m.gs_tau,
            m.gs_hard).float().cpu().numpy()
    if use_clustering:
        probs = 1.0 / (1.0 + np.exp(-cls_logits.float().cpu().numpy()))
        clusters = dbscan_clusters(
            probs, batch.prot_xyz.float().cpu().numpy(),
            batch.prot_mask.cpu().numpy(), m.dbscan_eps,
            m.dbscan_min_samples)
        centers = np.stack([pick_cluster_centers(
            clusters, m.choose_cluster_prob, default, rng)
            for _ in range(n_copies)])
    else:
        centers = np.tile(default[None], (n_copies, 1, 1))
    return randomized_init_copies(batch, n_copies, rng), centers


def make_confidence_eval_fn(model, cfg: FABindConfig,
                            pose_source: str = "inference") -> Callable:
    """evalf(batch, generator, init_coords=None, centers=None, shapes=None)
    -> (scores [C, B], rmsds [C, B]) over cfg.train.num_copies stochastic
    copies, without gradients: the raw material of ranking accuracy, hit
    rate and best-of-N measured outside the train step."""
    n_copies = cfg.train.num_copies
    gen_copies = _copy_source(pose_source)

    def evalf(batch: FABindBatch, generator: torch.Generator,
              init_coords=None, centers=None, shapes=None):
        device = batch.lig_coords.device
        with torch.no_grad():
            coords, scores = gen_copies(
                model, batch, copy_generators(generator, n_copies, device),
                shapes, _as_device(init_coords, device),
                _as_device(centers, device))
            return scores, rmsd_per_copy(coords, batch.lig_coords,
                                         batch.lig_mask)

    return evalf


def pick_best_by_confidence(coords: Tensor, scores: Tensor
                            ) -> Tuple[Tensor, Tensor]:
    """Best-of-N: coords [C, B, Nc, 3], scores [C, B] -> (the most
    confident copy's coords [B, Nc, 3], its score [B])."""
    best = scores.argmax(0)
    return (coords[best, torch.arange(coords.shape[1], device=best.device)],
            scores.max(0).values)
