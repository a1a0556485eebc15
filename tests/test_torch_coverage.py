"""The port covers the JAX package: every public function, class and method
of fabind_tpu, and every flag of its CLIs, has a counterpart in
fabind_tpu_torch or a stated reason why not.

Both packages are read with `ast`; neither is imported. A counterpart has
the same name in the port module of the same path (or of the module that
MODULES names), or is listed in RENAMED (JAX `module:name` -> port
`module:name`, which must exist). Otherwise the name is listed in
NOT_PORTED with a one-line reason. A table entry that no longer applies
fails too, so the tables stay true: a name added to fabind_tpu without a
counterpart fails here instead of hiding in ROADMAP prose.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Set

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "fabind_tpu"
PORT = REPO / "fabind_tpu_torch"

RDKIT = "an RDKit path; the port does not depend on RDKit (ROADMAP 3.5)"

# JAX module -> the port module that holds its counterparts
MODULES = {
    "ops/pallas/__init__.py": "ops/edge_gate.py",
    "ops/pallas/edge_gate.py": "ops/edge_gate.py",
    "parallel/mesh.py": "parallel/dp.py",
}

# JAX module:name -> port module:name
RENAMED = {
    "cli/sample.py:dbscan_cluster_centers": "sample.py:dbscan_clusters",
    "cli/sample.py:dbscan_clusters": "sample.py:dbscan_clusters",
    "cli/sample.py:pick_cluster_centers": "sample.py:pick_cluster_centers",
    "cli/sample.py:sample_poses": "sample.py:sample_poses",
    "cli/sample.py:sampling_prng_key": "sample.py:pass_seed",
    "models/esm2.py:convert_esm_state_dict":
        "train/convert.py:load_esm_state_dict",
    "models/esm2.py:embed_sequences":
        "models/esm2.py:Esm2Model.embed_sequences",
    "models/esm2.py:esm2_from_torch": "train/convert.py:load_esm_state_dict",
    "models/fabind.py:FABind.inference_from_pocket":
        "sample.py:stochastic_dock",
    "models/layers.py:MLPBlock.finish_scalar_rank1":
        "models/layers.py:MLPBlock.finish_scalar_rank1_pair",
    "models/layers.py:MLPBlock.l1": "models/layers.py:MLPBlock.lin1",
    "models/layers.py:xavier_uniform_gain": "models/fabind.py:init_params",
    "ops/graph.py:ComplexLayout.node_mask":
        "models/egnn.py:GraphInputs.node_mask",
    "ops/graph.py:ComplexLayout.scatter_sides":
        "ops/graph.py:ComplexLayout.assemble",
    "ops/graph.py:gather_neighbors": "ops/graph.py:gather_nodes",
    "ops/pallas/edge_gate.py:phi_rank1_tpu": "ops/edge_gate.py:phi_rank1_pair",
    "parallel/mesh.py:make_mesh": "parallel/dp.py:dp_devices",
    "parallel/mesh.py:batch_sharding": "parallel/dp.py:strided_rows",
    "parallel/mesh.py:shard_batch": "parallel/dp.py:strided_rows",
    "parallel/mesh.py:replicated": "parallel/dp.py:ReplicaSet",
    "parallel/mesh.py:replicate": "parallel/dp.py:ReplicaSet",
    "train/checkpoints.py:latest_step":
        "train/checkpoints.py:TrainCheckpointer.latest_step",
    "train/checkpoints.py:save_state":
        "train/checkpoints.py:TrainCheckpointer.save",
    "train/checkpoints.py:restore_state":
        "train/checkpoints.py:TrainCheckpointer.restore",
    "train/checkpoints.py:restore_params": "train/checkpoints.py:load_weights",
    "train/checkpoints.py:overlay": "train/checkpoints.py:load_into",
    "train/checkpoints.py:save_params_npz": "train/checkpoints.py:save_params",
    "train/checkpoints.py:load_params_npz": "train/checkpoints.py:load_params",
    "train/confidence.py:confidence_param_labels":
        "train/confidence.py:build_confidence_optimizer",
    "train/convert.py:convert_checkpoint":
        "train/convert.py:load_torch_checkpoint",
    "train/convert.py:export_torch_state_dict":
        "train/convert.py:state_dict_from_flax",
    "train/schedule.py:build_optimizer": "train/schedule.py:TrainOptimizer",
    "train/trainer.py:TrainState": "train/trainer.py:Trainer",
    "train/trainer.py:create_train_state": "train/trainer.py:Trainer",
    "train/trainer.py:BucketedTrainStep": "train/trainer.py:Trainer",
    "train/trainer.py:BucketedTrainStep.step_for":
        "train/trainer.py:Trainer.train_step",
    "train/trainer.py:make_eval_step": "train/trainer.py:eval_forward",
    "utils/precision.py:cast_tree_bf16": "utils/precision.py:cast_module_bf16",
}

# JAX module:name -> why the port has no counterpart
NOT_PORTED = {
    "data/featurize.py:canonical_renumber": RDKIT,
    "data/featurize.py:featurize_mol": RDKIT,
    "data/featurize.py:generate_conformation": RDKIT,
    "data/featurize.py:mol_from_sdf": RDKIT,
    "data/featurize.py:read_smiles": RDKIT,
    "data/featurize.py:write_renumbered_sdf": RDKIT,
    "data/isomorphism.py:mol_automorphisms": RDKIT,
    "serve.py:DockingEngine.dock_mols": RDKIT,
    "models/att_model.py:EfficientMCAttModel.setup":
        "flax setup; a torch module builds its children in __init__",
    "models/fabind.py:FABind.setup":
        "flax setup; a torch module builds its children in __init__",
    "models/layers.py:MLPBlock.setup":
        "flax setup; a torch module builds its children in __init__",
    "ops/pallas/edge_gate.py:phi_rank1_pallas":
        "the Pallas TPU kernel; its counterpart is the CUDA kernel "
        "csrc/edge_gate.cu behind ops/edge_gate.py phi_rank1_pair",
    "ops/graph.py:gather_nodes_mm":
        "one-hot matmul gather that works around slow TPU gathers; the "
        "port gathers by index (ops/graph.py gather_nodes)",
    "ops/graph.py:ComplexLayout.is_global":
        "no caller in fabind_tpu; the port's layout names the global slots "
        "(ComplexLayout.glb_c, glb_p)",
    "ops/graph.py:ComplexLayout.segment_id":
        "no caller in fabind_tpu; the port's layout slices the two sides "
        "(ComplexLayout.cside_slice, pside_slice)",
    "train/convert.py:convert_state_dict":
        "torch -> flax parameter tree; the port's modules load a torch "
        "state dict as it is (load_torch_checkpoint)",
    "train/trainer.py:make_train_step":
        "jit-step factory; the port's step is the method Trainer.train_step",
    "train/trainer.py:make_inference_step":
        "jit-step factory; the port runs FABind.inference_diag directly",
    "train/trainer.py:make_sharded_train_step":
        "jit-step factory over a mesh; the port's dp step is "
        "parallel/steps.py",
    "utils/logging_utils.py:init_wandb":
        "needs wandb, which the port does not depend on (ROADMAP 3.5)",
    "utils/logging_utils.py:log_to_wandb":
        "needs wandb, which the port does not depend on (ROADMAP 3.5)",
}

# CLI module -> flags of the JAX CLI the port's lacks, with the reason
FLAGS_NOT_PORTED = {
    "export.py": {"--platforms": "jax export platforms; the port has "
                                 "--device (an artifact serves on both)"},
    "inference.py": {"--esm-device": "jax device placement of ESM2; the "
                                     "port's encoder runs on --device"},
    "preprocess.py": {
        "--esm-device": "jax device placement of ESM2; the port's encoder "
                        "runs on --device",
        "--num-conformers": RDKIT, "--seed": RDKIT + " (conformer seed)",
        "--workers": RDKIT + " (conformer workers)"},
    "train.py": {"--compile-cache": "the XLA compilation cache; the port "
                                    "compiles no program",
                 "--wandb": "needs wandb, which the port does not "
                           "depend on"},
    "train_confidence.py": {"--wandb": "needs wandb, which the port "
                                       "does not depend on"},
}

FLAG = re.compile(r"--[a-z0-9][a-z0-9-]*")


def modules(root: Path) -> Dict[str, ast.Module]:
    return {p.relative_to(root).as_posix(): ast.parse(p.read_text())
            for p in sorted(root.rglob("*.py"))}


def public_names(tree: ast.Module) -> Set[str]:
    """Top-level public functions and classes, and `Class.method` for each
    public method of a public class."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
    return out


def flags(tree: ast.Module) -> Set[str]:
    """Every string constant of the form --flag (argparse option names)."""
    return {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and FLAG.fullmatch(n.value)}


JAX_MODULES = modules(JAX)
PORT_MODULES = modules(PORT)
JAX_NAMES = {m: public_names(t) for m, t in JAX_MODULES.items()}
PORT_NAMES = {m: public_names(t) for m, t in PORT_MODULES.items()}


def port_has(ref: str) -> bool:
    module, name = ref.split(":")
    return name in PORT_NAMES.get(module, set())


def test_every_jax_module_has_a_port_module():
    missing = [m for m in JAX_MODULES
               if MODULES.get(m, m) not in PORT_MODULES]
    assert not missing, f"JAX modules without a port module: {missing}"


def test_every_public_name_has_a_counterpart_or_a_reason():
    missing = []
    for module, names in JAX_NAMES.items():
        target = MODULES.get(module, module)
        for name in sorted(names):
            ref = f"{module}:{name}"
            if ref in RENAMED or ref in NOT_PORTED:
                continue
            if name not in PORT_NAMES.get(target, set()):
                missing.append(ref)
    assert not missing, (
        "public names of fabind_tpu with no counterpart in fabind_tpu_torch "
        "(port them, or list them in RENAMED or NOT_PORTED with a reason): "
        f"{missing}")


@pytest.mark.parametrize("table", ["RENAMED", "NOT_PORTED"])
def test_table_entries_are_current(table):
    """Each entry names a public name that fabind_tpu has and that has no
    same-name counterpart (else the entry is stale); a renamed counterpart
    exists in the port; a reason is one line."""
    entries = RENAMED if table == "RENAMED" else NOT_PORTED
    for ref, value in entries.items():
        module, name = ref.split(":")
        assert name in JAX_NAMES.get(module, set()), f"{ref}: not in JAX"
        target = MODULES.get(module, module)
        assert name not in PORT_NAMES.get(target, set()), \
            f"{ref}: the port has it under the same name"
        if table == "RENAMED":
            assert port_has(value), f"{ref} -> {value}: not in the port"
        else:
            assert value and "\n" not in value, ref


def test_pallas_kernel_counterpart_exists():
    """ops/pallas is not mirrored module by module: its one kernel is the
    CUDA source csrc/edge_gate.cu behind ops/edge_gate.py, which also keeps
    the plain reference."""
    assert (PORT / "csrc" / "edge_gate.cu").is_file()
    for name in ("phi_rank1_pair", "phi_rank1_pair_reference",
                 "phi_rank1_reference"):
        assert port_has(f"ops/edge_gate.py:{name}"), name
    pallas = [m for m in JAX_MODULES if m.startswith("ops/pallas/")]
    assert pallas and all(MODULES.get(m) == "ops/edge_gate.py"
                          for m in pallas)


@pytest.mark.parametrize("cli", sorted(
    p.name for p in (JAX / "cli").glob("*.py") if p.name != "__init__.py"))
def test_cli_flags_have_a_counterpart_or_a_reason(cli):
    jax_flags = flags(JAX_MODULES[f"cli/{cli}"])
    port_flags = flags(PORT_MODULES[f"cli/{cli}"])
    listed = FLAGS_NOT_PORTED.get(cli, {})
    missing = sorted(jax_flags - port_flags - set(listed))
    assert not missing, f"cli/{cli}: JAX flags the port lacks: {missing}"
    stale = sorted(set(listed) - (jax_flags - port_flags))
    assert not stale, f"cli/{cli}: listed but not missing: {stale}"
    assert all(r and "\n" not in r for r in listed.values())
