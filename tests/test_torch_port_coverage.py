"""The port covers the JAX package's public names.

Every public top-level function or class of the JAX package (read with
`ast`, nothing imported) exists somewhere in the port, or stands in
`NOT_PORTED` with its ground. `NOT_PORTED` agrees with ROADMAP.md's "Not
ported" section: each of its names is named there, and none of them has
since been ported.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "structure_knowledge_distillation_tpu"
PORT_PKG = REPO / "structure_knowledge_distillation_tpu_torch"

_MESH = "parallel/mesh.py's tp/sp/dcn mesh: XLA partitioning, the port shards by process"
_CKPT = "a JAX checkpoint format (msgpack, Orbax) or its torch crossing; the port saves torch"

NOT_PORTED = {
    "flops_of_jaxpr": "walks a jaxpr; `utils/flops.py::flops_of_fn` counts dispatched ops",
    "kernel_vmem_bytes": "the Pallas CE kernel's TPU VMEM budget; CUDA sizes by `ops/taps.py`",
    "argmax_kernel_fits": "the Pallas argmax's TPU VMEM gate; K1 tiles any size",
    "avg_pool_matrix": "the TPU's matmul form of the PSP pool; the port pools with torch",
    "fold_bn_variables": "flax variables; the port's fold is `models/fold.py::fold_bn_state_dict`",
    "make_mesh": _MESH,
    "batch_sharding": _MESH,
    "stacked_batch_sharding": _MESH,
    "replicated": _MESH,
    "spatial_sharding": _MESH,
    "param_shardings": _MESH,
    "state_shardings": _MESH,
    "shard_state": _MESH,
    "put_global": "one global array from per-host shards; each rank loads its own slice",
    "evaluate_spatial": "XLA spatial partitioning with halo exchange",
    "save_state_async": _CKPT,
    "wait_for_saves": _CKPT,
    "restore_latest": _CKPT,
    "save_state": _CKPT,
    "save_student_state": _CKPT,
    "restore_state": _CKPT,
    "load_student_variables": _CKPT,
    "map_torch_key": _CKPT,
    "import_torch_respspnet": _CKPT,
    "map_torch_discriminator_key": _CKPT,
    "import_torch_discriminator": _CKPT,
    "export_torch_respspnet": _CKPT,
    "export_torch_discriminator": _CKPT,
    "FlatSGDState": "one flat buffer for XLA's fused update; the port's is foreach ops",
    "make_flat_sgd": "one flat buffer for XLA's fused update; the port's is foreach ops",
    "create_train_state": "a flax TrainState; the port's state is `KDTrainState` of modules",
    "host_keyed_cache_dir": "XLA's persistent compilation cache",
    "GlobalAvgPool2d": "models/abn_blocks.py, the reference's dead library code",
    "DenseModule": "models/abn_blocks.py, the reference's dead library code",
    "IdentityResidualBlock": "models/abn_blocks.py, the reference's dead library code",
}


def public_names(package: Path) -> dict[str, str]:
    """Each public top-level function or class name -> the first module
    (relative path) that defines it."""
    out: dict[str, str] = {}
    for path in sorted(package.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                out.setdefault(node.name, str(path.relative_to(package)))
    return out


def _roadmap_not_ported() -> str:
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("**Not ported.**")
    return text[start:text.index("\n### ", start)]


def test_every_jax_name_is_ported_or_listed():
    port = public_names(PORT_PKG)
    missing = {name: module for name, module in public_names(JAX_PKG).items()
               if name not in port and name not in NOT_PORTED}
    assert not missing, missing


def test_not_ported_list_is_current_and_agrees_with_the_roadmap():
    jax_names, port = public_names(JAX_PKG), public_names(PORT_PKG)
    section = _roadmap_not_ported()
    named = set(re.findall(r"`([A-Za-z_][A-Za-z0-9_]*)`", section))
    for name, ground in NOT_PORTED.items():
        assert ground, name
        assert name in jax_names, f"{name} is no JAX name"
        assert name not in port, f"{name} is ported: take it off the list"
        assert name in named or jax_names[name] in section, \
            f"ROADMAP's Not ported section does not name {name} ({jax_names[name]})"
