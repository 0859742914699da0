"""Port parity: the sharded prefill forward over a (data 2, model 4) mesh.

The reference runs each case in a subprocess with 8 XLA CPU devices:
``backbone.forward`` on one device and under ``axis_rules(make_rules(mode))``
and ``jax.set_mesh`` of a ``(2, 4)`` ``("data", "model")`` mesh.  Its
parameters cross into the port by name (``models.weights.named_arrays``);
``repro_torch.dist.model_run`` runs every case in one spawn of 8 ``gloo``
CPU ranks, ``make_prefill_step(cfg, mesh=, rules=)`` and the forward of
every position.  At f32, as the reference's own mesh tests
(``tests/test_dist.py``), the logits agree at atol 1e-4:

* dbrx smoke at capacity 8.0 under ``tp``: expert parallel, two
  ``all_to_all`` a MoE layer;
* grok smoke with ``sharding="ffn"`` under ``tp_sp``: every expert's FFN
  shard on every rank, tokens sequence-parallel, no ``all_to_all``;
* StarCoder2-3B smoke under ``tp``, through the flash kernel's plain version
  on each rank's local heads;
* the three of them (the MoEs at capacity 8.0) under ``fsdp``, ``fsdp_sp``
  and ``tp2d``: the forward that training differentiates, ``tp2d`` with the
  MoE's ``extra_ffn`` over data and ``_StridedShard`` placements;

each against the single-device forward and the reference's mesh forward
(which equals it there: nothing is dropped at capacity 8.0), and the MoEs at
their config's capacity against the reference's mesh forward alone (each
rank counts capacity over its own tokens, so the drops are the mesh's).
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.dist import model_run
from repro_torch.models import attention as tattn
from repro_torch.models.weights import named_arrays
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
BATCH, SEQ = 4, 32
ARCHS = {"dbrx-132b": "dbrx_132b", "grok-1-314b": "grok_1_314b",
         "starcoder2-3b": "starcoder2_3b"}
# (name, case without its params file, whether nothing is dropped)
CASES = [
    ("dbrx_ep", model_run.Case("dbrx-132b", mode="tp", batch=BATCH, seq=SEQ, smoke=True,
                               param_dtype="float32", capacity_factor=8.0,
                               all_positions=True), True),
    ("dbrx_ep_config", model_run.Case("dbrx-132b", mode="tp", batch=BATCH, seq=SEQ, smoke=True,
                                      param_dtype="float32", all_positions=True), False),
    ("grok_tp_sp", model_run.Case("grok-1-314b", mode="tp_sp", moe_sharding="ffn", batch=BATCH,
                                  seq=SEQ, smoke=True, param_dtype="float32",
                                  capacity_factor=8.0, all_positions=True), True),
    ("grok_tp_sp_config", model_run.Case("grok-1-314b", mode="tp_sp", moe_sharding="ffn",
                                         batch=BATCH, seq=SEQ, smoke=True,
                                         param_dtype="float32", all_positions=True), False),
    ("starcoder_tp", model_run.Case("starcoder2-3b", mode="tp", batch=BATCH, seq=SEQ,
                                    smoke=True, param_dtype="float32", all_positions=True,
                                    use_flash=True), True),
] + [
    # fsdp (embed over data), fsdp_sp and tp2d (ffn and vocab over model x data:
    # the MoE's hidden dim split over data too, a _StridedShard layout)
    (f"{label}_{mode}", model_run.Case(arch, mode=mode, moe_sharding=sharding, batch=BATCH,
                                       seq=SEQ, smoke=True, param_dtype="float32",
                                       capacity_factor=cf, all_positions=True), True)
    for mode in ("fsdp", "fsdp_sp", "tp2d")
    for label, arch, sharding, cf in (("dbrx", "dbrx-132b", None, 8.0),
                                      ("grok", "grok-1-314b", "ffn", 8.0),
                                      ("starcoder", "starcoder2-3b", None, None))
]


def _reference(d):
    """Run the reference on every case; its parameters and results land in d."""
    spec = [{"name": name, "arch": ARCHS[case.arch], "mode": case.mode,
             "cf": case.capacity_factor, "sharding": case.moe_sharding,
             "tokens": os.path.join(d, f"{name}_tokens.npy"), "single": drop_free}
            for name, case, drop_free in CASES]
    for (name, case, _), row in zip(CASES, spec):
        np.save(row["tokens"], model_run.case_tokens(case))
    code = f"""
        import dataclasses, json, jax, numpy as np
        from repro.configs import get_smoke
        from repro.dist.sharding import axis_rules, make_rules
        from repro.models import backbone
        d = {d!r}
        for case in json.loads({json.dumps(json.dumps(spec))}):
            cfg = dataclasses.replace(get_smoke(case["arch"]), param_dtype="float32")
            moe = cfg.moe
            if case["cf"] is not None:
                moe = dataclasses.replace(moe, capacity_factor=case["cf"])
            if case["sharding"] is not None:
                moe = dataclasses.replace(moe, sharding=case["sharding"])
            cfg = dataclasses.replace(cfg, moe=moe)
            params, _ = backbone.init_model(jax.random.key(0), cfg)
            flat = {{}}
            def walk(t, prefix):
                if isinstance(t, dict):
                    for k, v in t.items():
                        walk(v, prefix + k + ".")
                else:
                    flat[prefix[:-1]] = np.asarray(t)
            walk(params, "")
            np.savez(f"{{d}}/{{case['name']}}_params.npz", **flat)
            batch = {{"tokens": np.load(case["tokens"])}}
            fwd = jax.jit(lambda p, b: backbone.forward(p, cfg, b))
            out = {{}}
            if case["single"]:
                out["single"] = np.asarray(fwd(params, batch)[0], np.float32)
            mesh = jax.make_mesh((2, 4), ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
            with axis_rules(make_rules(case["mode"])), jax.set_mesh(mesh):
                logits, aux = jax.jit(lambda p, b: backbone.forward(p, cfg, b))(params, batch)
            out["mesh"] = np.asarray(logits, np.float32)
            out["aux"] = np.float32(aux)
            np.savez(f"{{d}}/{{case['name']}}_out.npz", **out)
        print("OK")
    """
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _port_params(name, case, d):
    """The reference's parameters of one case under the port's names."""
    with np.load(os.path.join(d, f"{name}_params.npz")) as f:
        flat = dict(f)
    nested = {}
    for key, leaf in flat.items():
        node = nested
        *parents, last = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    path = os.path.join(d, f"{name}_port.npz")
    np.savez(path, **named_arrays(model_run.case_config(case), nested))
    return path


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as d:
        _reference(d)
        cases = [dataclasses.replace(case, params=_port_params(name, case, d))
                 for name, case, _ in CASES]
        rows = model_run.run(cases, workdir=os.path.join(d, "run"), device="cpu")
        out = {}
        for (name, case, drop_free), row in zip(CASES, rows):
            with np.load(os.path.join(d, f"{name}_out.npz")) as f:
                out[name] = (case, drop_free, row, dict(f))
        yield out


@pytest.mark.parametrize("name", [name for name, _, _ in CASES])
def test_sharded_forward_matches_reference_mesh_forward(runs, name):
    case, drop_free, row, ref = runs[name]
    np.testing.assert_allclose(row["logits_all"], ref["mesh"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(row["logits"], ref["mesh"][:, -1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(row["aux"], float(ref["aux"]), atol=1e-6, rtol=1e-5)
    if drop_free:
        np.testing.assert_allclose(row["logits_all"], ref["single"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", [name for name, _, _ in CASES])
def test_sharded_forward_collectives_by_kind(runs, name):
    case, drop_free, row, _ = runs[name]
    cfg = model_run.case_config(case)
    for rank in row["ranks"]:
        assert rank["collectives"].get("all_reduce", 0) > 0  # partial sums reduced
        moe = rank["moe_collectives"]
        if cfg.moe is None:
            assert rank["pairs_routed"] == 0 and sum(moe.values()) == 0
            continue
        expert_parallel = case.moe_sharding != "ffn"
        # EP: the dispatch and the return, one pair a layer; TP: none
        assert moe["all_to_all"] == (2 * cfg.n_layers if expert_parallel else 0)
        assert rank["collectives"].get("all_to_all", 0) == moe["all_to_all"]
        # the tokens gathered over an axis that splits both them and the
        # experts' hidden dim, the outputs scattered back: over model under
        # sequence parallelism (TP), over data under tp2d
        gathers = int(not expert_parallel and case.mode.endswith("_sp")) + int(case.mode == "tp2d")
        assert moe["all_gather"] == moe["reduce_scatter"] == gathers * cfg.n_layers
        assert rank["pairs_routed"] > 0
        if drop_free:
            assert rank["pairs_dropped"] == 0


def test_sharded_forward_runs_flash_on_local_heads(runs):
    case, _, row, _ = runs["starcoder_tp"]
    cfg = model_run.case_config(case)
    for rank in row["ranks"]:
        assert rank["flash_max_abs_err"] == 0.0  # on the CPU the kernel is its plain version
        # 6 query heads do not divide over 4: every rank holds them all
        assert rank["flash_shape"]["q"] == [BATCH // 2, SEQ, cfg.n_heads, cfg.head_dim]
        assert rank["flash_launches"] == 0  # the CPU runs the plain version: no launch


@pytest.mark.parametrize("heads,kv_heads,ranks", [(6, 3, 2), (8, 2, 4), (24, 2, 4),
                                                  (6, 2, 3), (12, 4, 2)])
def test_local_attention_reads_the_kv_heads_of_its_query_heads(heads, kv_heads, ranks):
    """Rank i's query heads read kv head h // (H // kvH) of the whole set:
    the ranks' outputs, side by side, are the one-device attention's."""
    cfg = dataclasses.replace(get_smoke("starcoder2-3b"), n_heads=heads, n_kv_heads=kv_heads,
                              d_model=heads * 16, param_dtype="float32")
    hd = cfg.head_dim
    rng = np.random.default_rng(heads + ranks)
    q2 = torch.from_numpy(rng.standard_normal((2, 24, heads * hd), dtype=np.float32))
    k2 = torch.from_numpy(rng.standard_normal((2, 24, kv_heads * hd), dtype=np.float32))
    v2 = torch.from_numpy(rng.standard_normal((2, 24, kv_heads * hd), dtype=np.float32))
    kw = dict(cfg=cfg, causal=True, chunk=8, use_flash=None)
    whole = tattn._local_attention(q2, k2, v2, h0=0, **kw)
    hl = heads // ranks
    parts = [tattn._local_attention(q2[..., r * hl * hd:(r + 1) * hl * hd], k2, v2, h0=r * hl,
                                    **kw) for r in range(ranks)]
    torch.testing.assert_close(torch.cat(parts, dim=-1), whole, atol=1e-6, rtol=1e-6)


class FakeMesh:
    mesh_dim_names = ("data", "model")
    shape = (2, 4)


def test_unsharded_model_and_decode_raise_under_a_mesh():
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models import backbone

    cfg = get_smoke("starcoder2-3b")
    model = backbone.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with use_mesh(FakeMesh()):
        with pytest.raises(ValueError, match="shard_model"):
            backbone.forward(model, cfg, {"tokens": tokens})
        state = backbone.init_decode_state(cfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="shard_model"):
            backbone.decode_step(model, cfg, state, tokens[:, :1], 0)


def test_make_model_mesh_needs_a_world_of_its_size(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_model_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_model_mesh((2, 4), device_type="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 8 ranks, the world has 1"):
            make_model_mesh((2, 4), device_type="cpu")
        with pytest.raises(ValueError, match="differ in length"):
            make_model_mesh((1,), ("data", "model"), device_type="cpu")
        mesh = make_model_mesh((1, 1), device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_host_staging_is_scoped_and_only_for_gloo_groups(tmp_path):
    """The staged all-gather is a CUDA kernel only inside ``host_staging()``,
    stages a gloo group's gather through the host (counting both copies),
    and refuses a group of any other backend instead of staging it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import obs
    from repro_torch.dist import mesh_collectives
    from repro_torch.launch.mesh import make_model_mesh

    op = "_c10d_functional::all_gather_into_tensor"
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    with mesh_collectives.host_staging():
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        mesh = make_model_mesh((1, 1), device_type="cpu")
        with obs.tracing("staging") as tr:
            got = mesh_collectives._staged_all_gather(x, 1, mesh.get_group("model").group_name)
        assert torch.equal(got, x)
        assert tr.counter_value("mesh.bytes.host_staged") == 2 * x.numel() * 4
    finally:
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="host staging is for gloo groups"):
            mesh_collectives._staged_all_gather(x, 2, dist.group.WORLD.group_name)
    finally:
        dist.destroy_process_group()


def test_model_run_defaults_to_the_card():
    import inspect

    from repro_torch.serve import make_prefill_step

    assert inspect.signature(model_run.run).parameters["device"].default == "cuda"
    assert inspect.signature(make_prefill_step).parameters["device"].default == "cuda"
