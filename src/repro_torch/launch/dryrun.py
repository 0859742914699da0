"""Dry run of one (arch x shape x mesh) cell on a cluster the program does
not run on: the counterpart of ``repro.launch.dryrun``.

Rank 0 of a ``fake`` process group of the production mesh's size (256 or
512 ranks, in this one process) builds the cell's state, parameters and
AdamW moments, or the decode state, and its batch as fake tensors under
``FakeTensorMode`` (nothing is allocated), lays them out over
``make_production_mesh`` under the cell's rules, and runs ONE step of the
cell's kind through the port's own ``make_train_step`` /
``make_prefill_step`` / ``make_decode_step`` with ``mesh=``.  A
:class:`Meter` below DTensor's dispatch sees rank 0's local work, op by op:

* ``memory``: ``argument_bytes`` (rank 0's bytes of parameters, optimizer or
  decode state and batch, the batch laid out as the reference's dry run
  lays it), ``peak_bytes`` (those plus the most bytes of the step's own
  tensors live at once: each fake storage counted from the op that made it
  until it is freed), ``per_device_total_gib`` and the 80 GB budget;
* ``roofline``: FLOPs (``torch.utils.flop_counter``'s formulas on rank 0's
  local shapes, the flash kernel's custom op among them), HBM bytes (the
  input and output bytes of every op rank 0 dispatches, views aside),
  collective bytes (each collective's output) over the H100 data sheet's
  rates (``launch.mesh``), the bottleneck, and ``useful_flops_ratio``
  against the reference's ``model_flops_global``;
* ``collectives``: bytes and counts by kind, and the largest.

No HLO exists: this counting takes the place of the reference's
``hlo_analysis``.  The artifact is ``{arch}__{shape}__{mesh}__{rules}.json``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
      --shape prefill_32k --mesh multi --rules tp --out artifacts_torch/dryrun

``--device cpu`` runs the CPU's paths (the chunked attention, a ``cpu`` mesh);
the default, ``cuda``, makes fake card tensors over a ``cuda`` mesh, so the
flash kernel's custom op is what the prefill counts.  Nothing is launched.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import weakref
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import applicable_shapes, get_config, input_specs
from repro_torch.dist.model_run import KINDS, _kind
from repro_torch.dist.sharding import (
    axis_rules,
    is_dtensor,
    make_rules,
    resolve_spec,
    shard_tensor,
)
from repro_torch.launch.mesh import (
    COLLECTIVE_BW,
    HBM_BW,
    HBM_BYTES,
    PEAK_FLOPS_BF16,
    fake_world,
    make_model_mesh,
    make_production_mesh,
)
from repro_torch.models import backbone
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.weights import shard_model
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step

_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")


def model_flops_global(cfg: ArchConfig, shape: ShapeConfig, kind: str) -> float:
    """The reference's useful FLOPs of one step: 6·N_active·D to train,
    2·N_active·D to prefill, 2·N_active per sequence to decode a token."""
    n_active = cfg.active_params()
    if kind == "train":
        return 6.0 * n_active * shape.tokens
    if kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # decode: one new token


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


class Meter(TorchDispatchMode):
    """Rank 0's local work, op by op (it sits below DTensor: a DTensor op is
    handed back to DTensor, whose ops on local tensors come here): FLOPs by
    ``flop_registry``, the input and output bytes of every op but views,
    collectives by kind (their output bytes), and the bytes of the tensors
    the ops make that are live at once (a storage counts from its first
    op's output until it is freed).  With ``buffers`` it also keeps, at each
    new peak, the live storages' (dtype and shape, op) for
    ``launch.buffers``.

    Only ops on tensors of ``fake_mode`` (the step's) count, and none that
    DTensor's sharding propagation runs: the first time it meets an op it
    runs it once more on global-shape fake tensors to learn the output's
    shape, which is not rank 0's work (``ShardingPropagator.
    _propagate_tensor_meta_non_cached`` is wrapped to pause the count while
    it runs)."""

    def __init__(self, fake_mode: FakeTensorMode, *, buffers: bool = False) -> None:
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.hbm_bytes = 0
        self.coll_bytes: dict[str, int] = {}
        self.coll_counts: dict[str, int] = {}
        self.coll_sizes: list[tuple[str, int]] = []
        self.flops_by_op: dict[str, int] = {}
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._buffers = {} if buffers else None
        self.peak_buffers: list[tuple[str, str, int]] = []
        self._paused = 0
        self._unwrap = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name)
        meter = self

        def paused(prop, *args, **kwargs):
            meter._paused += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                meter._paused -= 1

        setattr(ShardingPropagator, name, paused)
        self._unwrap = lambda: setattr(ShardingPropagator, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        self._unwrap()
        return super().__exit__(*exc)

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        if self._buffers is not None:
            self._buffers.pop(key, None)

    def _track(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        nbytes = st.nbytes()
        self._seen[st] = nbytes
        self.live += nbytes
        weakref.finalize(st, self._free, id(st), nbytes)
        if self._buffers is not None:
            self._buffers[id(st)] = (f"{str(t.dtype).removeprefix('torch.')}"
                                     f"{list(t.shape)}", op, nbytes)
        if self.live > self.peak:
            self.peak = self.live
            if self._buffers is not None:
                self.peak_buffers = list(self._buffers.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if self._paused or any(t.device.type == "meta" or getattr(
                t, "fake_mode", self.fake_mode) is not self.fake_mode for t in ins):
            return out
        self.ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _kind(func)
            if kind in KINDS:
                nbytes = sum(_nbytes(t) for t in outs)
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + nbytes
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
                self.coll_sizes.append((kind, nbytes))
        else:
            if packet in flop_registry:
                # the formulas read tensor shapes: ``bmm.dtype``'s out_dtype
                # would land on their ``out_shape``
                n = int(flop_registry[packet](
                    *(a for a in args if not isinstance(a, torch.dtype)), **kwargs,
                    out_val=out))
                self.flops += n
                name = str(packet).removeprefix("aten.")
                self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
            if not func.is_view:
                self.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t, packet.__name__)
        return out


# the reference's dry-run batch axes (launch/dryrun.py::_batch_axes)
def _batch_axes(batch: dict) -> dict:
    return {key: ("batch", None) if key in ("tokens", "labels") else ("batch", None, "embed")
            for key in batch}


def _local_bytes(full: torch.Tensor, axes, mesh, rules) -> int:
    return _nbytes(shard_tensor(full, mesh, resolve_spec(axes, full.shape, mesh, rules))
                   .to_local())


@dataclasses.dataclass
class Cell:
    """One cell's fake state, laid out over the mesh."""
    kind: str
    model: Any
    batch: dict
    opt: dict | None = None
    decode_state: dict | None = None

    def argument_bytes(self, mesh, rules) -> int:
        """Rank 0's bytes of what the reference's jitted step takes as
        arguments: parameters, the optimizer or decode state, the batch (on
        the reference's batch axes)."""
        total = sum(_nbytes(_local(p)) for p in self.model.parameters())
        for tree in (self.opt, self.decode_state):
            if tree is not None:
                total += sum(_nbytes(_local(t)) for t in tree_leaves(tree)
                             if isinstance(t, torch.Tensor))
        axes = _batch_axes(self.batch)
        total += sum(_local_bytes(t, axes[key], mesh, rules) for key, t in self.batch.items())
        return total


def train_config(cfg: ArchConfig, *, microbatches: int = 1, attn_chunk: int = 512,
                 opt_dtype: str | None = None, accum_dtype: str = "float32") -> TrainConfig:
    return TrainConfig(optimizer=AdamWConfig(state_dtype=opt_dtype or cfg.opt_state_dtype),
                       microbatches=microbatches, attn_chunk=attn_chunk, accum_dtype=accum_dtype)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, rules, tcfg: TrainConfig,
               device: str) -> Cell:
    """The cell's state as fake tensors (call under ``FakeTensorMode`` and
    the fake world): the model laid out by ``shard_model`` (with gradients
    and zero AdamW moments to train, as ``init_train_state`` builds them),
    the decode state laid out by ``init_decode_state(..., mesh=)``, the
    whole batch (``input_specs``; each step shards it)."""
    model = backbone.Backbone(cfg, device=device)
    model.requires_grad_(shape.kind == "train")
    shard_model(model, mesh, rules)
    cell = Cell(shape.kind, model, input_specs(cfg, shape, device=device))
    if shape.kind == "train":
        cell.opt = init_opt_state(model, tcfg.optimizer)
    elif shape.kind == "decode":
        with axis_rules(rules):
            cell.decode_state = backbone.init_decode_state(
                cfg, shape.global_batch, shape.seq_len, device=device, mesh=mesh)
    return cell


def run_step(cell: Cell, cfg: ArchConfig, shape: ShapeConfig, tcfg: TrainConfig, mesh, rules,
             device: str, attn_chunk: int = 512):
    """One step of the cell's kind through the port's step functions (a
    decode step at the cache's last position)."""
    if cell.kind == "train":
        step = make_train_step(cfg, tcfg, mesh=mesh, rules=rules)
        return step(cell.model, cell.opt, cell.batch, 0)
    if cell.kind == "prefill":
        step = make_prefill_step(cfg, attn_chunk, device=device, mesh=mesh, rules=rules)
        return step(cell.model, cell.batch)
    step = make_decode_step(cfg, device=device, mesh=mesh, rules=rules)
    return step(cell.model, cell.decode_state, cell.batch["tokens"], shape.seq_len - 1)


def measure_cell(cfg: ArchConfig, shape: ShapeConfig, *, multi_pod: bool, rules_mode: str,
                 tcfg: TrainConfig, device: str = "cuda", attn_chunk: int = 512,
                 buffers: bool = False, mesh_shape: tuple | None = None) -> dict:
    """Build the cell and run its step under a :class:`Meter`: the counts,
    the argument and peak bytes, the host seconds.  ``mesh_shape`` replaces
    the production mesh (tests).  The whole cell runs inside its own
    ``fake`` process group (``launch.mesh.fake_world``), which refuses to
    start beside any other and is gone on return: what comes back is
    numbers and the :class:`Meter`."""
    rules = make_rules(rules_mode, multi_pod=multi_pod)
    world = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod else 256)
    with fake_world(world, 0):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        else:
            axes = ("pod", "data", "model") if multi_pod else ("data", "model")
            mesh = make_model_mesh(mesh_shape, axes, device_type=device)
        t0 = time.perf_counter()
        with FakeTensorMode(allow_non_fake_inputs=True) as fake_mode:
            cell = build_cell(cfg, shape, mesh, rules, tcfg, device)
            args = cell.argument_bytes(mesh, rules)
            build_s = time.perf_counter() - t0
            with Meter(fake_mode, buffers=buffers) as meter:
                out = run_step(cell, cfg, shape, tcfg, mesh, rules, device, attn_chunk)
                outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
                out_bytes = sum(_nbytes(_local(t)) for t in outs)
            del out, outs
        step_s = time.perf_counter() - t0 - build_s
    return {"n_devices": world, "argument_bytes": args, "peak_bytes": args + meter.peak,
            "output_bytes": out_bytes, "meter": meter, "build_s": build_s, "step_s": step_s}


def roofline(flops: float, hbm_bytes: float, coll_bytes: float, model_flops: float) -> dict:
    """The three terms over the H100 data sheet's rates (``launch.mesh``)."""
    terms = {"compute": flops / PEAK_FLOPS_BF16, "memory": hbm_bytes / HBM_BW,
             "collective": coll_bytes / COLLECTIVE_BW}
    return {"flops": flops, "hbm_bytes": hbm_bytes, "collective_bytes": coll_bytes,
            "compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"], "bottleneck": max(terms, key=terms.get),
            "model_flops": model_flops,
            "useful_flops_ratio": model_flops / flops if flops else 0.0}


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    rules_mode: str = "tp_sp",
    microbatches: int = 1,
    attn_chunk: int = 512,
    remat: str | None = None,
    opt_dtype: str | None = None,
    accum_dtype: str = "float32",
    verbose: bool = True,
    device: str = "cuda",
    config: ArchConfig | None = None,
    shape: ShapeConfig | None = None,
    mesh_shape: tuple | None = None,
) -> dict:
    """The reference's ``run_cell``, with the same arguments and result keys;
    ``device`` (``cuda`` by default, ``cpu`` for the CPU's paths), and for
    tests a ``config``, a ``shape`` and a ``mesh_shape`` in place of the
    named arch's, shape's and the production mesh."""
    cfg = config or get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = shape or SHAPES[shape_name]
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "rules": rules_mode,
        "microbatches": microbatches,
        "attn_chunk": attn_chunk,
        "remat": cfg.remat,
        "params_b": round(cfg.params_billions, 3),
        "active_params_b": round(cfg.active_params() / 1e9, 3),
        "device": device,
    }
    if shape_name in SHAPES and shape_name not in applicable_shapes(cfg):
        result.update(
            status="skipped",
            reason="pure full-attention arch: long_500k needs sub-quadratic decode",
        )
        return result
    tcfg = train_config(cfg, microbatches=microbatches, attn_chunk=attn_chunk,
                        opt_dtype=opt_dtype, accum_dtype=accum_dtype)
    got = measure_cell(cfg, shape, multi_pod=multi_pod, rules_mode=rules_mode, tcfg=tcfg,
                       device=device, attn_chunk=attn_chunk, mesh_shape=mesh_shape)
    meter = got["meter"]
    n = got["n_devices"]
    model_flops = model_flops_global(cfg, shape, shape.kind) / n
    coll = sum(meter.coll_bytes.values())
    result.update(
        status="ok",
        kind=shape.kind,
        n_devices=n,
        build_s=round(got["build_s"], 1),
        step_s=round(got["step_s"], 1),
        ops=meter.ops,
        memory={
            "argument_bytes": got["argument_bytes"],
            "output_bytes": got["output_bytes"],
            "temp_bytes": got["peak_bytes"] - got["argument_bytes"],
            "peak_bytes": got["peak_bytes"],
            "per_device_total_gib": round(got["peak_bytes"] / 2**30, 3),
            "budget_gib": round(HBM_BYTES / 2**30, 3),
            "fits": got["peak_bytes"] <= HBM_BYTES,
        },
        roofline=roofline(float(meter.flops), float(meter.hbm_bytes), float(coll), model_flops),
        flops_by_op=meter.flops_by_op,
        collectives={
            "bytes_by_op": meter.coll_bytes,
            "count_by_op": meter.coll_counts,
            "largest": sorted(meter.coll_sizes, key=lambda t: -t[1])[:8],
        },
    )
    if verbose:
        r = result["roofline"]
        print(f"[dryrun] {arch} x {shape_name} x {result['mesh']} ({rules_mode}): OK "
              f"mem/dev={result['memory']['per_device_total_gib']} GiB "
              f"build={got['build_s']:.1f}s step={got['step_s']:.1f}s "
              f"bottleneck={r['bottleneck']} terms(c/m/x)=({r['compute_s']:.4f},"
              f"{r['memory_s']:.4f},{r['collective_s']:.4f})s "
              f"useful={r['useful_flops_ratio']:.3f}")
        print("collectives:", result["collectives"]["bytes_by_op"])
    return result


def artifact_name(res: dict) -> str:
    return f"{res['arch']}__{res['shape']}__{res['mesh']}__{res['rules']}.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--rules", default="tp_sp",
                    choices=["tp", "fsdp", "tp_sp", "fsdp_sp", "tp2d"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--remat", default=None, choices=[None, "none", "dots", "full"])
    ap.add_argument("--opt-dtype", default=None)
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="directory for the JSON artifact")
    args = ap.parse_args(argv)
    res = run_cell(
        args.arch,
        args.shape,
        multi_pod=args.mesh == "multi",
        rules_mode=args.rules,
        microbatches=args.microbatches,
        attn_chunk=args.attn_chunk,
        remat=args.remat,
        opt_dtype=args.opt_dtype,
        accum_dtype=args.accum_dtype,
        device=args.device,
    )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, artifact_name(res)), "w") as f:
            json.dump(res, f, indent=1)
    return 0 if res.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
