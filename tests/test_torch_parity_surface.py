"""The port's public surface against the JAX package's.

For every module of ``torchsnapshot_tpu/`` with a file of the same name in
``torchsnapshot_tpu_torch/``, every public top-level function and class,
and every public method of each class the port also has (public or not),
must exist in the port, or stand in :data:`ALLOWLIST` with its reason. A
method that the JAX class defines over its base's default must be defined
by the port's class too, not inherited from the base's default: that is
how a consumer that never streams hides. The JAX side is read from its
source (``ast``), the port's by importing it. The modules with no file of
the same name are listed, with their counterparts, in
:data:`NO_COUNTERPART`.

Then the names this guard found missing and the port now has, each held
to the JAX package: ``faultinject.refresh_from_env``,
``TransformerConfig.param_count`` and ``scheduler.stream_reads_enabled``.
"""

from __future__ import annotations

import ast
import importlib
import os
from typing import Dict, List, Set, Tuple

import pytest
import torch

import torchsnapshot_tpu
import torchsnapshot_tpu_torch

JAX_ROOT = os.path.dirname(torchsnapshot_tpu.__file__)
PORT_ROOT = os.path.dirname(torchsnapshot_tpu_torch.__file__)

#: JAX modules with no port file of the same name -> their counterpart.
NO_COUNTERPART = {
    "_aio.py": None,  # none by design: the fs plugin calls the loop's executor itself (ROADMAP queue 1)
    "ops/pallas_attention.py": "ops/flash_attention.py",
    "tricks/flax_train.py": "tricks/train_state.py",
    "tricks/orbax_interop.py": "tricks/dcp_interop.py",
}

#: "module:Name" or "module:Class.method" of the JAX package -> why the
#: port has no such name.
ALLOWLIST = {
    # JAX-only: jax arrays, shardings and the jax.distributed world.
    "io_preparers/prepare.py:is_jax_array": "JAX-only; the port takes torch tensors",
    "io_preparers/prepare.py:is_sharded_jax_array": "JAX-only; the port has is_sharded_dtensor",
    "io_preparers/prepare.py:is_partitionable_array": "JAX-only; the port has is_dtensor",
    "io_preparers/array.py:to_host": "JAX-only (np.asarray of a jax array); no caller in the JAX "
                                     "package",
    "io_preparers/array.py:needs_consistency_copy": "JAX-only platform rule; the port passes "
                                                     "copy_cpu",
    "io_preparers/array.py:zero_copy_staging": "JAX-only context; the port passes copy_cpu to the "
                                               "preparers",
    "io_preparers/array.py:DeviceMaterializer": "JAX-only device_put per sub-chunk; the port lands CUDA "
                                                 "tensors in place (_DeviceScratchSink)",
    "layout.py:LayoutSpec.named_sharding": "JAX-only NamedSharding; the port has placements_for",
    "layout.py:LayoutSpec.shardings_for": "JAX-only NamedSharding; the port has placements_by_path",
    "test_utils.py:init_pod_world": "JAX-only jax.distributed world; the port has run_with_subprocesses",
    # Done under another name.
    "serialization.py:array_as_memoryview": "done as tensor_as_memoryview",
    "serialization.py:array_from_buffer": "done as tensor_from_buffer",
    "io_preparers/array.py:fast_copyto": "done as _copy_cpu (torch copy_)",
    "io_preparers/array.py:ArrayAssembler": "done as _ArrayAssembler",
    "io_preparers/array.py:array_nbytes": "done inline as numel() * element_size()",
    "io_preparers/array.py:iter_staged_pieces": "done inline in warmup_staging and CheckpointManager "
                                                "(ShardedArrayIOPreparer._owned_pieces)",
    "io_preparers/array.py:_StagingPool.can_recycle": "done as _StagingPool.available (native "
                                                      "slabs only)",
    "io_preparers/array.py:get_array_size_from_entry": "done as serialization.array_size_bytes",
    "io_preparers/chunked.py:get_chunked_array_size": "done as serialization.array_size_bytes",
    "io_preparers/chunked.py:ChunkedArrayIOPreparer.chunk_ranges": "done as "
                                                                   "ChunkedArrayIOPreparer.chunk_shards",
    "io_preparers/object.py:serialized_size_bytes": "done at planning: ObjectBufferStager pickles once",
    "io_preparers/object.py:ObjectBufferConsumer.set_consume_callback": "done as the consumer's "
                                                                        "constructor argument",
    "_native/__init__.py:slab_allocator_available": "done as native_available",
    "_native/__init__.py:slab_view": "done as slab_alloc, wrapped by _StagingPool",
    "test_utils.py:tree_eq": "JAX test helper over numpy trees; the port's tests use torch.equal",
    "test_utils.py:assert_state_dict_eq": "JAX test helper; the port's tests use torch.equal",
    "test_utils.py:check_state_dict_eq": "JAX test helper; the port's tests use torch.equal",
    "test_utils.py:rand_array": "JAX test helper; the port's tests draw from numpy seeds",
    # Deliberate differences (ROADMAP queue 3).
    **{f"analysis/plugins/legacy_{name}.py:main": "no scripts/ wrappers: the pass runs through "
       "cli.py lint (run_pass; a deliberate difference of ROADMAP queue 3)"
       for name in ("event_taxonomy", "fault_sites", "peer_channel", "stream_contract", "timing")},
    # Unused: no caller in the JAX package or its tests.
    "fanout.py:CoopKeyPlan.n_send": "no caller in the JAX package or its tests",
    "fanout.py:CoopKeyPlan.n_recv": "no caller in the JAX package or its tests",
    "reshard.py:ComposedRestorePlan.n_send": "no caller in the JAX package or its tests",
    "reshard.py:ComposedRestorePlan.n_recv": "no caller in the JAX package or its tests",
    "reshard.py:ComposedRestorePlan.mark_done": "no caller: SendRole marks its CoopKeyPlan, OwnerUnit "
                                                "its ReshardContext",
}

#: Names this guard found missing that the port now has: never allowlisted.
CLOSED = ("can_stream", "consume_stream", "refresh_from_env", "param_count", "stream_reads_enabled")


def _jax_sources() -> Dict[str, str]:
    out = {}
    for dirpath, dirnames, filenames in os.walk(JAX_ROOT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    out[os.path.relpath(path, JAX_ROOT)] = f.read()
    return out


def _public(name: str) -> bool:
    return not name.startswith("_")


def _own_methods(node: ast.ClassDef) -> Set[str]:
    return {m.name for m in node.body if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _port_module(rel: str):
    name = rel[: -len(".py")].replace(os.sep, ".")
    if name.endswith("__init__"):
        name = name[: -len(".__init__")]
    return importlib.import_module("torchsnapshot_tpu_torch" + (f".{name}" if name else ""))


def _top_level(tree: ast.Module) -> List[ast.stmt]:
    return [n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]


def missing_names(sources: Dict[str, str]) -> List[str]:
    """Every public JAX name of ``sources`` (relative path -> source) with
    no counterpart in the port, as ``module:Name`` or
    ``module:Class.method``."""
    trees = {rel: ast.parse(src) for rel, src in sources.items()}
    jax_classes: Dict[Tuple[str, str], Set[str]] = {
        (rel, n.name): _own_methods(n)
        for rel, tree in trees.items() for n in tree.body if isinstance(n, ast.ClassDef)
    }
    missing = []
    for rel, tree in sorted(trees.items()):
        if not os.path.exists(os.path.join(PORT_ROOT, rel)):
            continue
        if rel == "__main__.py":  # importing it runs the command line
            with open(os.path.join(PORT_ROOT, rel)) as f:
                port_names = {n.name for n in _top_level(ast.parse(f.read()))}
            missing += [f"{rel}:{n.name}" for n in _top_level(tree)
                        if _public(n.name) and n.name not in port_names]
            continue
        module = _port_module(rel)
        for node in _top_level(tree):
            if _public(node.name) and not hasattr(module, node.name):
                missing.append(f"{rel}:{node.name}")
            port_class = getattr(module, node.name, None)
            if not isinstance(node, ast.ClassDef) or not isinstance(port_class, type):
                continue
            for method in sorted(filter(_public, _own_methods(node))):
                owner = next((k for k in port_class.__mro__ if method in vars(k)), None)
                if owner is None:
                    missing.append(f"{rel}:{node.name}.{method}")
                    continue
                if owner is port_class or not owner.__module__.startswith("torchsnapshot_tpu_torch."):
                    continue
                # Inherited from a port base: a fault where the JAX class
                # overrides that very base's method.
                base_rel = owner.__module__.split(".", 1)[1].replace(".", os.sep) + ".py"
                if method in jax_classes.get((base_rel, owner.__name__), set()):
                    missing.append(f"{rel}:{node.name}.{method}")
    return missing


def test_every_public_jax_name_has_a_counterpart_or_a_reason() -> None:
    missing = missing_names(_jax_sources())
    unexplained = [m for m in missing if m not in ALLOWLIST]
    assert not unexplained, f"JAX names with no port counterpart and no ALLOWLIST entry: {unexplained}"
    stale = sorted(set(ALLOWLIST) - set(missing))
    assert not stale, f"ALLOWLIST entries the port now has (remove them): {stale}"


def test_the_allowlist_gives_reasons_and_never_names_a_closed_gap() -> None:
    for name, reason in ALLOWLIST.items():
        assert reason.strip(), name
        assert name.rsplit(":", 1)[1].rsplit(".", 1)[-1] not in CLOSED, name


def test_modules_without_a_same_named_file_are_listed_with_counterparts() -> None:
    unmatched = sorted(rel for rel in _jax_sources() if not os.path.exists(os.path.join(PORT_ROOT, rel)))
    assert unmatched == sorted(NO_COUNTERPART)
    for counterpart in filter(None, NO_COUNTERPART.values()):
        assert os.path.exists(os.path.join(PORT_ROOT, counterpart)), counterpart


def test_a_new_jax_function_without_a_counterpart_fails_the_guard() -> None:
    sources = _jax_sources()
    sources["faultinject.py"] += "\n\ndef brand_new_public_name():\n    pass\n"
    assert "faultinject.py:brand_new_public_name" in missing_names(sources)


def test_a_jax_override_that_the_port_inherits_fails_the_guard() -> None:
    """A method that a JAX class defines over its base's default, while
    the port's class inherits the port base's default, is reported: the
    port's ObjectBufferConsumer inherits BufferConsumer.can_stream."""
    sources = _jax_sources()
    rel = "io_preparers/object.py"
    tree = ast.parse(sources[rel])
    klass = next(n for n in tree.body
                 if isinstance(n, ast.ClassDef) and n.name == "ObjectBufferConsumer")
    klass.body.append(ast.parse("def can_stream(self, sub_chunk_bytes):\n    return True\n").body[0])
    sources[rel] = ast.unparse(tree)
    assert f"{rel}:ObjectBufferConsumer.can_stream" in missing_names(sources)
    assert f"{rel}:ObjectBufferConsumer.can_stream" not in missing_names(_jax_sources())


# ------------------------------------------ the names closed, against JAX


def test_refresh_from_env_matches_the_jax_package(monkeypatch) -> None:
    """A plan set after import is picked up, a malformed one raises, an
    unset one disables: as JAX ``tests/test_faultinject.py`` checks."""
    from torchsnapshot_tpu import faultinject as JF
    from torchsnapshot_tpu_torch import faultinject as PF

    try:
        for spec in ("fs.write@1=transient", "fs.pread@2=corrupt;seed=3"):
            monkeypatch.setenv(PF.FAULT_PLAN_ENV_VAR, spec)
            monkeypatch.setenv(JF.FAULT_PLAN_ENV_VAR, spec)
            PF.refresh_from_env()
            JF.refresh_from_env()
            assert PF.active() and JF.active()
            assert PF.active_spec() == JF.active_spec() == spec
        for bad in ("fs.write@1", "no.such.site@1=transient", "fs.write@1=explode"):
            monkeypatch.setenv(PF.FAULT_PLAN_ENV_VAR, bad)
            monkeypatch.setenv(JF.FAULT_PLAN_ENV_VAR, bad)
            errors = []
            for module in (PF, JF):
                with pytest.raises(Exception) as e:
                    module.refresh_from_env()
                errors.append(type(e.value).__name__)
            assert errors[0] == errors[1] == "ValueError", bad
        monkeypatch.delenv(PF.FAULT_PLAN_ENV_VAR)
        monkeypatch.delenv(JF.FAULT_PLAN_ENV_VAR)
        PF.refresh_from_env()
        JF.refresh_from_env()
        assert not PF.active() and not JF.active()
    finally:
        PF.disable()
        JF.disable()


DENSE_CONFIGS = [
    dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128),
    dict(vocab_size=1000, d_model=96, n_heads=3, n_layers=3, d_ff=200),
    dict(vocab_size=8192, d_model=128, n_heads=8, n_layers=1, d_ff=512),
]


# The default config, a MoE (the formula counts a dense FFN) and the wide one.
OTHER_CONFIGS = [{}, dict(n_experts=4), dict(d_model=2048, n_heads=8, d_ff=8192)]


@pytest.mark.parametrize("kw", DENSE_CONFIGS + OTHER_CONFIGS)
def test_param_count_equals_the_jax_configs(kw) -> None:
    from torchsnapshot_tpu.models.transformer import TransformerConfig as JConfig
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    assert TransformerConfig(**kw).param_count == JConfig(**kw).param_count


@pytest.mark.parametrize("kw", DENSE_CONFIGS)
def test_param_count_is_the_dense_models_numel(kw) -> None:
    from torchsnapshot_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(**kw)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = [params["embed"], params["ln_f_scale"], *params["layers"].values()]
    assert sum(t.numel() for t in leaves) == cfg.param_count


@pytest.mark.parametrize("raw", [None, "", "never", "NEVER ", "0", "false", "off", "no", "always",
                                 "force", "auto", "1", "bogus"])
def test_stream_reads_enabled_matches_the_jax_package(monkeypatch, raw) -> None:
    from torchsnapshot_tpu import scheduler as JS
    from torchsnapshot_tpu_torch import scheduler as PS

    for var in ("TORCHSNAPSHOT_GPU_STREAM_READS", "TORCHSNAPSHOT_TPU_STREAM_READS"):
        if raw is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, raw)
    assert PS.stream_reads_enabled() == JS.stream_reads_enabled() == (PS.stream_reads_mode() != "never")
