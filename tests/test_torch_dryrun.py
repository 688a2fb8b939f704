"""The port's meta-device dry run (``launch.dryrun``) against ``repro``'s.

JAX's ``run_one`` lowers and compiles on its 256- or 512-device production
mesh, which one CPU process does not have; its records that do not come
from XLA are arithmetic on the config, the shape and the mesh's axis
sizes. So the tests hold the port's helpers (``arch_config``,
``microbatches_for``, ``needs_fsdp``, ``needs_serve_fsdp``,
``optimizer_for``, ``SKIPS``) to JAX's for every registry arch x shape,
the mesh sizes to what ``make_production_mesh`` asks of ``jax.make_mesh``,
and ``run_one``'s analytic fields to JAX's own lines with JAX's functions
on the same arguments (the port's roofline patched to JAX's v5e, single
pod and multi-pod, with the int8-cache and serve-2d variants; the int8
weights' at the three archs of the bytes test, whose meta int8 trees are
slow to build). The argument bytes are the sum over JAX's builder inputs
on a 1 x 1 mesh, exactly.

JAX's dry run sets ``XLA_FLAGS`` (512 host devices) when imported; the
fixture restores it at once. This process's JAX backend has one device
(tests/conftest.py), and no later test or subprocess sees the flag.
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.core import analytic_cost as jac  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.specs import ShardingPolicy as JaxPolicy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402

V5E = cm.HardwareSpec(name=jcm.V5E.name, peak_flops=jcm.V5E.peak_flops,
                      hbm_bw=jcm.V5E.hbm_bw, link_bw=jcm.V5E.ici_bw,
                      links_per_chip=4.0)
VARIANTS = ({}, {"int8_kv": True}, {"serve_2d": True})
ANALYTIC = ("status", "note", "kind", "chips", "params", "active_params",
            "flops", "hbm_bytes", "collective_bytes", "scan_trips", "compute_s",
            "memory_s", "collective_s", "dominant", "model_flops",
            "useful_flop_frac", "policy")


@pytest.fixture(scope="module")
def jd():
    """``repro.launch.dryrun``, its ``XLA_FLAGS`` assignment undone."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("XLA_FLAGS", raising=False)     # restored on exit
        mod = importlib.import_module("repro.launch.dryrun")
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_meta_tree_per_config():
    """``steps.params_shape`` memoized by (config, quantized): a record reads
    only shapes, so the sweeps share one meta init per config."""
    cache = {}
    build = steps.params_shape

    def memo(model, quantized=False):
        key = (model.cfg, quantized)
        if key not in cache:
            cache[key] = build(model, quantized)
        return cache[key]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps, "params_shape", memo)
        yield


def _jax_mesh_sizes(multi_pod):
    """The axis sizes JAX's ``make_production_mesh`` asks for."""
    from repro.launch import mesh as jmesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh.jax, "make_mesh", lambda shape, axes: dict(zip(axes, shape)))
        return jmesh.make_production_mesh(multi_pod=multi_pod)


def _cfg_dict(cfg):
    return dataclasses.asdict(cfg)


def test_constants_and_mesh_sizes_are_jaxs(jd):
    assert dryrun.SKIPS == jd.SKIPS
    assert dryrun.LONG_SWA_WINDOW == jd.LONG_SWA_WINDOW
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for mp in (False, True):
        assert dryrun.mesh_axis_sizes(mp) == _jax_mesh_sizes(mp)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_helpers_are_jaxs(arch, jd):
    """``arch_config`` (both remat policies), ``microbatches_for``,
    ``needs_fsdp`` / ``needs_serve_fsdp`` at the model axis of 1 and 16
    and ``optimizer_for`` equal JAX's at every input shape."""
    for shape in INPUT_SHAPES:
        for variant in ({}, {"remat_dots": True}):
            cfg, sh, note = dryrun.arch_config(arch, shape, variant)
            jcfg, jsh, jnote = jd.arch_config(arch, shape, variant)
            assert _cfg_dict(cfg) == _cfg_dict(jcfg) and note == jnote
            assert dataclasses.astuple(sh) == dataclasses.astuple(jsh)
        assert dryrun.microbatches_for(cfg, sh) == jd.microbatches_for(jcfg, jsh)
        for m in (1, 16):
            assert dryrun.needs_fsdp(cfg, m) == jd.needs_fsdp(jcfg, m)
            assert dryrun.needs_serve_fsdp(cfg, m) == jd.needs_serve_fsdp(jcfg, m)
        o, jo = dryrun.optimizer_for(cfg), jd.optimizer_for(jcfg)
        assert type(o).__name__ == type(jo).__name__
        assert dataclasses.asdict(o) == dataclasses.asdict(jo)


def _jax_analytic(jd, arch, shape_name, multi_pod, variant):
    """JAX ``run_one``'s analytic fields: its lines, with its functions, at
    the sizes of the mesh it builds (the lowering left out)."""
    if (arch, shape_name) in jd.SKIPS:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": jd.SKIPS[(arch, shape_name)]}
    cfg, shape, note = jd.arch_config(arch, shape_name, variant)
    sizes = _jax_mesh_sizes(multi_pod)
    m_size = sizes.get("model", 1)
    fsdp = (jd.needs_fsdp(cfg, m_size) if shape.kind == "train"
            else jd.needs_serve_fsdp(cfg, m_size))
    expert_2d = cfg.family == "moe" and cfg.param_count() * 2 / m_size > 10e9
    serve_2d = bool(variant.get("serve_2d")) and shape.kind != "train"
    pol = JaxPolicy(data=("pod", "data") if multi_pod else "data", model="model",
                    fsdp=fsdp, expert_2d=expert_2d, replicate_batch=serve_2d,
                    mesh_axis_sizes=sizes)
    chips = int(np.prod(list(sizes.values())))
    nmb = jd.microbatches_for(cfg, shape) if shape.kind == "train" else 1
    acost = jac.step_cost(
        cfg, shape, chips=chips, fsdp=pol.fsdp, num_microbatches=nmb,
        data_size=sizes.get("data", 1) * sizes.get("pod", 1),
        w_bytes=(1 if variant.get("int8_w") and shape.kind != "train" else None),
        cache_elem_bytes=(1 if variant.get("int8_kv") else 2),
        weight_gather=(pol.fsdp and shape.kind != "train"
                       and not variant.get("serve_2d")))
    terms = jcm.roofline_terms(acost.flops, acost.hbm_bytes,
                               acost.collective_bytes, chips)
    n_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * cfg.active_param_count() * n_tok
    return {"status": "ok", "note": note, "kind": shape.kind, "chips": chips,
            "params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "flops": acost.flops, "hbm_bytes": acost.hbm_bytes,
            "collective_bytes": acost.collective_bytes,
            "scan_trips": jac.scan_trips(cfg, shape.kind, nmb),
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s, "dominant": terms.dominant,
            "model_flops": model_flops,
            "useful_flop_frac": model_flops / acost.flops if acost.flops else 0.0,
            "policy": {"fsdp": pol.fsdp, "expert_2d": pol.expert_2d,
                       "serve_2d": pol.replicate_batch}}


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_analytic_fields_are_jaxs(arch, jd, monkeypatch):
    """Every shape, single pod and multi-pod, each variant: ``run_one``'s
    analytic fields (and a skip's record) equal JAX's, exactly, with the
    port's roofline on JAX's v5e."""
    monkeypatch.setattr(cm, "DEFAULT_HW", V5E)
    for shape in INPUT_SHAPES:
        for multi_pod in (False, True):
            for variant in VARIANTS:
                got = dryrun.run_one(arch, shape, multi_pod, verbose=False,
                                     variant=variant)
                want = _jax_analytic(jd, arch, shape, multi_pod, variant)
                if want["status"] == "skipped":
                    assert got == want
                    continue
                assert (got["arch"], got["shape"], got["multi_pod"]) == \
                    (arch, shape, multi_pod)
                assert {k: got[k] for k in ANALYTIC} == want, (shape, multi_pod, variant)


def _nbytes(tree):
    return sum(int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b", "whisper-large-v3"])
def test_arg_bytes_are_the_sum_over_jaxs_builder_inputs(arch, jd, monkeypatch):
    """``per_device_arg_bytes`` (the port's step inputs on one device) is
    the sum of nbytes over JAX's builder inputs on a 1 x 1 mesh, at every
    shape, with and without int8 weights and an int8 cache; the analytic
    fields of these records equal JAX's too."""
    monkeypatch.setattr(cm, "DEFAULT_HW", V5E)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    pol = JaxPolicy(data="data", model="model",
                    mesh_axis_sizes={"data": 1, "model": 1})
    for shape in INPUT_SHAPES:
        if (arch, shape) in jd.SKIPS:
            continue
        for q in (False, True):
            for kv in (False, True):
                got = dryrun.run_one(arch, shape, False, verbose=False,
                                     variant={"int8_w": q, "int8_kv": kv})
                cfg, sh, _ = jd.arch_config(arch, shape)
                with mesh:
                    _, inputs = jd.build(jax_build(cfg), mesh, pol, sh, cfg,
                                         quantized=q, cache_int8=kv)
                want = _nbytes(jd.flatten_inputs(sh.kind, inputs))
                assert got["per_device_arg_bytes"] == want, (shape, q, kv)
                want = _jax_analytic(jd, arch, shape, False,
                                     {"int8_w": q, "int8_kv": kv})
                assert {k: got[k] for k in ANALYTIC} == want, (shape, q, kv)


def test_main_writes_its_own_file_and_resumes(tmp_path, monkeypatch, capsys):
    """``main`` records into its results file (the port's own, here a
    temporary one), ``--skip-done`` runs only what is missing, and a
    failing record is saved as failed and ends the sweep with exit 1."""
    path = tmp_path / "dryrun_results_torch.json"
    monkeypatch.setattr(dryrun, "RESULTS", path)
    assert dryrun.RESULTS.name != "dryrun_results.json"
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k"])
    assert list(json.loads(path.read_text())) == ["llama3.2-1b|decode_32k|sp|"]
    ran = []
    run_one = dryrun.run_one
    monkeypatch.setattr(dryrun, "run_one",
                        lambda a, s, mp, **kw: ran.append(s) or run_one(a, s, mp, **kw))
    dryrun.main(["--arch", "llama3.2-1b", "--skip-done"])
    assert ran == ["train_4k", "prefill_32k", "long_500k"]
    res = json.loads(path.read_text())
    assert sorted(res) == sorted(f"llama3.2-1b|{s}|sp|" for s in INPUT_SHAPES)
    assert all(r["status"] == "ok" for r in res.values())
    assert "ALL DRY-RUNS OK" in capsys.readouterr().out

    def fail(arch, shape, multi_pod, **kw):
        raise RuntimeError("no such step")
    monkeypatch.setattr(dryrun, "run_one", fail)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--multi-pod",
                     "--tag", "x"])
    assert e.value.code == 1
    rec = json.loads(path.read_text())["llama3.2-1b|train_4k|mp|x"]
    assert rec["status"] == "failed" and "no such step" in rec["error"]
