"""Dry run of the production mesh (port of ``repro/launch/dryrun.py``):
trace one step of every (architecture x input shape) over ``meta``
DTensors on the 16 x 16 (or 2 x 16 x 16) mesh and read its per-device
cost.

The reference lowers and compiles against forced host devices; here one
process stands for rank 0 of a ``fake`` process group of 256 (512)
ranks, every argument is a ``meta`` tensor laid out by the sharding
rules (:mod:`repro_torch.launch.sharding`), and the step runs eagerly
under :class:`~repro_torch.launch.cost_analysis.CostCounter`.  It holds
no tensor data and needs no card.  Layers that make plain tensors (RoPE
frequencies, masks, positions) run under ``implicit_replication()``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--shapes ...]

Writes one JSON per combination under ``results/dryrun_torch/``.  The
record keeps the reference's keys where they mean something here:
``ok``, ``flops_per_dev`` (and ``flops_by_op``, its split by op),
``bytes_per_dev``, ``collective_bytes_per_dev``, ``collective_by_kind``,
``memory`` (``argument_bytes``: the local shard
bytes of the arguments; ``output_bytes``; ``temp_bytes``: the peak live
bytes the step allocated beyond the arguments), ``roofline``.  The
reference's ``lower_s`` and ``compile_s`` become one ``trace_s``; its
``hlo_bytes``, ``xla_cost_analysis``, ``trip_counts`` and ``alias_bytes``
have no counterpart and are left out.

The roofline constants are the H100 SXM5's data-sheet values.  A 16-wide
"model" axis spans two 8-GPU NVLink nodes, so ``t_collective`` (all
collective bytes over one NVLink 4 direction) is a lower bound there.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.launch.specs import (decode_window_for, input_shape,
                                      input_specs, params_specs)
from repro_torch.models import model as M
from repro_torch.models import shardctx
from repro_torch.models.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, make_verify_step)
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import flatten, tree_map

# ---------------------------------------------------------------------------
# Hardware constants: NVIDIA H100 SXM5 data sheet (dense, no sparsity)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12        # bf16 FLOP/s per GPU
HBM_BW = 3.35e12           # HBM3 bytes/s per GPU
LINK_BW = 450e9            # NVLink 4 bytes/s per direction per GPU


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process rank 0: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fill_inputs(specs, cfg, shp, seed):
    """Draw the non-cache inputs in place from ``seed``: token ids, the
    positions (within the sequence), aux inputs ~ N(0, 1)."""
    gen = None
    for path, t in flatten(specs):
        if path[0] == "cache":
            continue
        if gen is None:
            gen = torch.Generator(device=t.device).manual_seed(seed)
        if path[-1] == "tokens":
            t.random_(0, cfg.vocab, generator=gen)
        elif path[-1] == "positions":
            t.random_(0, shp.seq_len, generator=gen)
        else:
            t.normal_(generator=gen)


def build_step(cfg, shape, mesh, *, device="meta", seed=0):
    """Returns ``(fn, args, placements)``: the step, its arguments (a
    tuple of trees of ``meta`` tensors, or on another ``device`` real ones
    -- parameters from ``init_params(cfg, seed)``, an empty cache, random
    tokens) and their placements on ``mesh``.  Installs the ``logits``,
    ``mesh_batch_axes`` and ``moe_mesh`` hints
    (:mod:`repro_torch.models.shardctx`).  ``shape`` is an
    ``INPUT_SHAPES`` name or an ``InputShape``."""
    shp = input_shape(shape)
    mode = "train" if shp.kind == "train" else "serve"
    meta = torch.device(device).type == "meta"
    params = (params_specs(cfg) if meta
              else M.init_params(cfg, seed, device=device))
    p_pl = SH.params_shardings(mesh, cfg, params, mode=mode)
    specs = input_specs(cfg, shp, device=device)
    if not meta:
        _fill_inputs(specs, cfg, shp, seed)
    B = shp.global_batch
    shardctx.set_hints(
        logits=SH.logits_sharding(mesh, cfg, B),
        mesh_batch_axes=(mesh, batch_axes(mesh)),
        moe_mesh=(mesh, batch_axes(mesh)) if cfg.n_experts else None)

    if shp.kind == "train":
        n_par = cfg.param_count()
        opt = AdamW(state_dtype=torch.bfloat16 if n_par > 1e11
                    else torch.float32)
        # in-step gradient accumulation so activations fit (the
        # reference's choice)
        micro = 16 if n_par > 1e11 else (8 if n_par > 5e9 else 1)
        o = opt.init(params)
        rep = SH.to_placements((), mesh)
        o_pl = AdamWState(
            step=rep,
            mu=SH.params_shardings(mesh, cfg, o.mu, mode="train"),
            nu=SH.params_shardings(mesh, cfg, o.nu, mode="train"))
        fn = make_train_step(cfg, opt, micro_batches=micro)
        return (fn, (params, o, specs["batch"]),
                (p_pl, o_pl, SH.batch_shardings(mesh, specs["batch"])))

    c_pl = SH.cache_shardings(mesh, cfg, specs["cache"], B)
    if shp.kind == "prefill":
        fn0 = make_prefill_step(cfg)
        aux = specs["aux"]

        def fn(p, c, t, a):
            return fn0(p, c, t, aux_inputs=a or None)
        return (fn, (params, specs["cache"], specs["tokens"], aux),
                (p_pl, c_pl, SH.batch_shardings(mesh, specs["tokens"]),
                 SH.batch_shardings(mesh, aux)))

    window = decode_window_for(cfg, shp)
    # decode (Tq = 1: naive is the decode) and verify (a 32-token chunk
    # over a 32k cache) take the grouped naive attention, as the reference
    step = make_decode_step if shp.kind == "decode" else make_verify_step
    fn = step(cfg.replace(attn_impl="naive"), window=window)
    return (fn, (params, specs["cache"], specs["tokens"], specs["positions"]),
            (p_pl, c_pl, SH.batch_shardings(mesh, specs["tokens"]),
             SH.batch_shardings(mesh, specs["positions"])))


def shard_args(args, placements, mesh):
    """Every argument leaf as a DTensor with its placements."""
    def one(t, pl):
        if isinstance(t, dict):
            return tree_map(lambda x, p: distribute_tensor(x, mesh, p), t, pl)
        if isinstance(t, AdamWState):
            return AdamWState(*(one(a, b) for a, b in zip(t, pl)))
        return distribute_tensor(t, mesh, pl)
    return tuple(one(a, p) for a, p in zip(args, placements))


def _local_bytes(tree) -> int:
    out = 0
    for t in _tensors(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        out += loc.numel() * loc.element_size()
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def measure(fn, args, *, sync=None):
    """Run the step once under the cost counter (with
    ``implicit_replication``); returns (output, cost, memory, seconds).
    ``sync`` (e.g. ``torch.cuda.synchronize``) is called before the clock
    is read."""
    arg_bytes = _local_bytes(args)
    t0 = time.perf_counter()
    with implicit_replication():
        out, cost = analyze(fn, *args)
    if sync is not None:
        sync()
    secs = time.perf_counter() - t0
    memory = {"argument_bytes": arg_bytes, "output_bytes": _local_bytes(out),
              "temp_bytes": cost.pop("peak_bytes")}
    return out, cost, memory, secs


def roofline(cfg, shape, cost, n_dev) -> dict:
    shp = input_shape(shape)
    n_tokens = shp.global_batch * (
        1 if shp.kind == "decode" else
        cfg.max_verify_chunk if shp.kind == "verify" else shp.seq_len)
    # train: 6ND (fwd 2ND + bwd 4ND); inference: 2ND
    model_flops = ((6.0 if shp.kind == "train" else 2.0)
                   * cfg.active_param_count() * n_tokens)
    r = {"t_compute": cost["flops"] / PEAK_FLOPS,
         "t_memory": cost["bytes"] / HBM_BW,
         "t_collective": cost["collective_bytes"] / LINK_BW,
         "model_flops_per_dev": model_flops / n_dev,
         "useful_flops_ratio": (model_flops / n_dev) / max(cost["flops"], 1.0)}
    terms = {k: r[f"t_{k}"] for k in ("compute", "memory", "collective")}
    r["bottleneck"] = max(terms, key=terms.get)
    return r


def trace_record(cfg, shape, mesh) -> dict:
    """Build, shard and trace one step on ``mesh`` (its process group
    already up); the record's measured keys."""
    n_dev = mesh.size()
    try:
        t0 = time.perf_counter()
        fn, args, pl = build_step(cfg, shape, mesh)
        args = shard_args(args, pl, mesh)
        _, cost, memory, _ = measure(fn, args)
        rec = {"ok": True, "trace_s": round(time.perf_counter() - t0, 2),
               "flops_per_dev": cost["flops"],
               "flops_by_op": cost["flops_by_op"],
               "bytes_per_dev": cost["bytes"],
               "collective_bytes_per_dev": cost["collective_bytes"],
               "collective_by_kind": cost["collective_by_kind"],
               "unresolved_dots": cost["unresolved_dots"],
               "memory": memory,
               "roofline": roofline(cfg, shape, cost, n_dev)}
    finally:
        shardctx.clear_hints()
    return rec


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: str = "results/dryrun_torch", cfg_override=None,
            tag: str = "") -> dict:
    cfg = cfg_override or get_config(arch)
    n = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "chips": n,
           "tag": tag}
    try:
        with fake_world(n):
            mesh = make_production_mesh(multi_pod=multi_pod)
            rec.update(trace_record(cfg, shape_name, mesh))
    except Exception as e:  # noqa: BLE001 -- record the failure, sweep on
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    os.makedirs(out_dir, exist_ok=True)
    suffix = "_mp" if multi_pod else ""
    tag_s = f"_{tag}" if tag else ""
    fname = (f"{out_dir}/{arch.replace('.', '_')}_{shape_name}{suffix}"
             f"{tag_s}.json")
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = (args.shapes or
              ([args.shape] if args.shape else
               ["train_4k", "prefill_32k", "decode_32k", "long_500k"]))

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, multi_pod=args.multi_pod,
                          out_dir=args.out, tag=args.tag)
            if rec["ok"]:
                r = rec["roofline"]
                print(f"OK   {arch:28s} {shape:12s} mesh={rec['mesh']:9s} "
                      f"trace={rec['trace_s']:7.1f}s "
                      f"t_comp={r['t_compute']:.2e} t_mem={r['t_memory']:.2e} "
                      f"t_coll={r['t_collective']:.2e} -> {r['bottleneck']}",
                      flush=True)
            else:
                n_fail += 1
                print(f"FAIL {arch:28s} {shape:12s}: {rec['error']}",
                      flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run failures")


if __name__ == "__main__":
    main()
