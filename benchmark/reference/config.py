"""Typed configuration for fabind_tpu_torch.

An own copy of the JAX package's configuration (fabind_tpu/config.py): the
same dataclasses and the same named presets, so a config built on either side
describes the same model. Kept as a copy because the port imports nothing
from fabind_tpu.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ShapeConfig:
    """Static shape bucket. All device tensors are padded to these sizes.

    The reference bounds sizes by dataset filters (c_length<100/150,
    protein_length<1000/1500 — FABind/fabind/data.py:110,
    FABind_plus/fabind/data.py:128-137) and the 20Å pocket crop.
    """

    max_ligand: int = 128          # Nc: ligand atoms
    max_pocket: int = 256          # Np: pocket residues (20Å crop)
    max_protein: int = 1024        # Nr: whole-protein residues
    bond_k: int = 6                # max bonded neighbors per atom
    ctx_k: int = 32                # top-K radius neighbors (protein-protein, 8Å)
    # K for the whole-protein pocket-prediction graph (denser; same 8Å cutoff)
    ctx_k_whole: int = 32

    @property
    def complex_nodes(self) -> int:
        return self.max_ligand + self.max_pocket + 2

    @property
    def whole_nodes(self) -> int:
        return self.max_ligand + self.max_protein + 2


@dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters.

    Defaults correspond to the released FABind base checkpoint command
    (FABind/fabind/test_fabind.py:182-185).
    """

    variant: str = "fabind"        # "fabind" | "fabind_plus"

    hidden_size: int = 512
    pocket_pred_hidden_size: int = 128
    mean_layers: int = 4
    pocket_pred_layers: int = 1
    n_iter: int = 8
    pocket_pred_n_iter: int = 1
    random_n_iter: bool = True

    coordinate_scale: float = 5.0
    inter_cutoff: float = 10.0
    intra_cutoff: float = 8.0
    pocket_radius: float = 20.0

    gs_tau: float = 1.0
    gs_hard: bool = False
    center_dist_threshold: float = 4.0
    stage_prob: float = 0.25
    train_pred_pocket_noise: float = 0.0

    rm_layernorm: bool = True
    add_attn_pair_bias: bool = True
    explicit_pair_embed: bool = True
    add_cross_attn_layer: bool = True
    keep_trig_attn: bool = False
    # EGNN ablation stacks (reference att_model.py:139-150): replace the
    # interfacial attention layers with plain EGCLs over the inter edges,
    # optionally keeping the cross-attention trio encoder
    ablation_no_attention: bool = False
    ablation_no_attention_with_cross_attn: bool = False
    # FABind+ attention distance-pair bias (model_utils.py:109-146,270):
    # "none" | "add" (pre-softmax) | "mul" (post-softmax)
    rel_dis_pair_bias: str = "none"
    opm: bool = False
    fix_pocket: bool = False
    rm_F_norm: bool = False
    norm_type: str = "per_sample"  # per_sample | all_sample | none

    dropout: float = 0.1
    # rematerialize each EGNN layer in the backward pass: cuts the dominant
    # training residuals ([B,N,K,C] ctx gathers + pair activations, one per
    # layer) at the cost of one recomputed forward (torch.utils.checkpoint)
    remat: bool = False
    geometry_reg_step_size: float = 0.001
    geom_reg_steps: int = 1
    rm_LAS_constrained_optim: bool = False
    only_last_LAS: bool = False

    # attention primitives (cross_att.py:98-116; FABind_plus parsing.py:181)
    mha_heads: int = 4
    mha_hidden: int = 32

    dis_map_thres: float = 10.0    # 15.0 for fabind_plus
    compound_coords_init_mode: str = "pocket_center_rdkit"

    # --- FABind+ only ---
    mlp_hidden_scale: int = 4      # 1 for released fabind_plus
    use_ln_mlp: bool = False       # True for released fabind_plus
    inter_additional_mlp: bool = False
    pocket_radius_buffer: float = 5.0
    min_pocket_radius: float = 20.0
    force_fix_radius: bool = False
    use_for_radius_pred: str = "ligand"   # ligand | both | global
    # confidence head (FABind_plus/fabind/models/model.py:52-61)
    confidence_training: bool = False
    stack_mlp: bool = False
    confidence_use_ln_mlp: bool = False
    confidence_dropout: float = 0.0
    confidence_mlp_hidden_scale: int = 4
    # DBSCAN pocket-center sampling (host-side; model.py:147-167)
    use_clustering: bool = False
    dbscan_eps: float = 9.0
    dbscan_min_samples: int = 2
    choose_cluster_prob: float = 0.5
    # sampling protocol (cli/sample.py:sample_poses): "stochastic" = the
    # reference's one-full-stochastic-forward-per-pass (pocket logits,
    # clusters, embeddings all per-pass; inference_sampling_fabind.py:
    # 148-167); "fixed" = deterministic pocket stage once per batch,
    # clusters computed once, only the random pick + dock-forward dropout
    # vary per pass (a documented deviation, measurably faster)
    sampling_pocket_mode: str = "stochastic"

    use_esm2_feat: bool = True
    esm2_concat_raw: bool = False

    # FABFlex-style blind flexible docking (linked from FABind/README.md:55-71;
    # no code in the reference snapshot): let pocket residue coordinates move
    # in the docking stage instead of staying frozen between recycles.
    flexible_docking: bool = False

    @property
    def protein_feat_dim(self) -> int:
        if self.esm2_concat_raw:
            return 1295
        return 1280 if self.use_esm2_feat else 15

    compound_feat_dim: int = 56

    @property
    def is_plus(self) -> bool:
        return self.variant == "fabind_plus"

    def normalize(self, v):
        return v / self.coordinate_scale

    def unnormalize(self, v):
        return v * self.coordinate_scale


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (FABind/fabind/main_fabind.py:256-287,398-417)."""

    batch_size: int = 8
    lr: float = 1e-4
    optim: str = "adamw"           # adam | adamw
    weight_decay: float = 0.01
    lr_scheduler: str = "constant"  # constant|poly_decay|cosine_decay|cosine_decay_restart|exp_decay
    warmup_epochs: int = 15
    total_epochs: int = 400
    steps_per_epoch: int = 1000     # for schedule construction
    clip_grad: bool = True
    gradient_accumulate_step: int = 1
    seed: int = 128

    coord_loss_function: str = "SmoothL1"   # MSE | SmoothL1
    coord_loss_weight: float = 1.0
    pair_distance_loss_weight: float = 1.0
    pair_distance_distill_loss_weight: float = 1.0
    pocket_cls_loss_weight: float = 1.0
    pocket_distance_loss_weight: float = 0.05
    pocket_cls_loss_func: str = "bce"
    pocket_coord_huber_delta: float = 3.0
    pocket_radius_loss_weight: float = 0.05   # FABind+ (training.py:71-74)
    dismap_choice: str = "ori"      # ori | npair | wodm (FABind+ training.py:64-69)
    permutation_invariant: bool = False
    # padded-grid BCE parity with reference (main_fabind.py:398); see DESIGN.md
    legacy_padded_bce: bool = True

    addNoise: float = 5.0
    train_ligand_torsion_noise: bool = False
    # uniform random rotation of the rdkit-conformer init at train time
    # (reference data.py:63-68 applies it unconditionally for the
    # pocket_center_rdkit init; True is reference-exact). False isolates
    # the permutation-invariant loss from orientation augmentation —
    # used by tools/train_plus_convergence_probe.py, where rotation per
    # step makes the min-loss automorphism flip randomly and a
    # small-capacity model collapses to the basin midpoint.
    train_rotation: bool = True
    # flexible-docking pocket-coordinate supervision (SmoothL1 vs the
    # dataset's pocket coords — holo self-consistency unless the data source
    # supplies a distinct apo input structure)
    flex_pocket_coord_loss_weight: float = 1.0

    # confidence training (FABind_plus/fabind/train_confidence.py)
    num_copies: int = 5
    ranking_loss: str = "logsigmoid"  # logsigmoid | dynamic_hinge
    keep_cls_2A: bool = False
    # ranking-pair scope: "within" is the reference protocol (its mandatory
    # batch_size=1 + num_copies duplicates of ONE complex,
    # train_confidence.py:218, makes every pair within-complex); "global"
    # is a documented extension that also ranks cross-complex pairs (an
    # absolute pose-quality scale). See train/confidence.py.
    ranking_pair_scope: str = "within"

    bf16: bool = False
    dp_size: int = 1                # data-parallel mesh size


@dataclass(frozen=True)
class FABindConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    shapes: ShapeConfig = field(default_factory=ShapeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "FABindConfig":
        return dataclasses.replace(self, **kw)


def preset(name: str, **overrides) -> FABindConfig:
    """Named configs for the two released checkpoints.

    - "fabind": FABind base (test_fabind.py:182-185).
    - "fabind_plus": FABind+ regression (test_regression_fabind.py:42).
    - "fabind_plus_sampling": FABind+ with confidence head + clustering
      (inference_sampling_fabind.py:69).
    - "fabflex": FABind base with FABFlex-style blind flexible docking
      (pocket residues move during recycling; linked from
      FABind/README.md:55-71 — no reference code exists, this preset is the
      architectural hook SURVEY.md §7 P8 describes).
    """
    if name == "fabind":
        cfg = FABindConfig()
    elif name == "fabflex":
        cfg = FABindConfig(model=ModelConfig(flexible_docking=True))
    elif name in ("fabind_plus", "fabind_plus_sampling"):
        model = ModelConfig(
            variant="fabind_plus",
            hidden_size=512,
            pocket_pred_hidden_size=128,
            mean_layers=5,
            n_iter=8,
            mlp_hidden_scale=1,
            use_ln_mlp=True,
            dropout=0.1,
            dis_map_thres=15.0,
            pocket_radius_buffer=5.0,
            min_pocket_radius=20.0,
            use_for_radius_pred="ligand",
            confidence_training=(name == "fabind_plus_sampling"),
            use_clustering=(name == "fabind_plus_sampling"),
            stage_prob=0.5,
        )
        train = TrainConfig(
            batch_size=2,
            lr=5e-5,
            lr_scheduler="poly_decay",
            total_epochs=1500,
            coord_loss_weight=1.5,
            permutation_invariant=True,
            seed=224,
        )
        # FABind+ raises the ligand-size filter to c_length<150
        # (FABind_plus/fabind/data.py:128-138)
        shapes = ShapeConfig(max_ligand=160, max_protein=1536)
        cfg = FABindConfig(model=model, shapes=shapes, train=train)
    else:
        raise ValueError(f"unknown preset: {name!r}")

    if overrides:
        model_kw = {k: v for k, v in overrides.items()
                    if k in {f.name for f in dataclasses.fields(ModelConfig)}}
        shape_kw = {k: v for k, v in overrides.items()
                    if k in {f.name for f in dataclasses.fields(ShapeConfig)}}
        train_kw = {k: v for k, v in overrides.items()
                    if k in {f.name for f in dataclasses.fields(TrainConfig)}}
        unknown = set(overrides) - set(model_kw) - set(shape_kw) - set(train_kw)
        if unknown:
            raise ValueError(f"unknown config overrides: {unknown}")
        cfg = FABindConfig(
            model=dataclasses.replace(cfg.model, **model_kw),
            shapes=dataclasses.replace(cfg.shapes, **shape_kw),
            train=dataclasses.replace(cfg.train, **train_kw),
        )
    return cfg


def parse_overrides(pairs) -> dict:
    """`--set KEY=VALUE` strings -> a typed override dict for `preset`
    (int, then float, then true/false, else the string)."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"true": True, "false": False}.get(v.lower(), v)
        out[k] = v
    return out
