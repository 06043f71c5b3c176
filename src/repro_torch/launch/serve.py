"""Serving launcher: bring up the cloud engine + verification-aware
scheduler for a trained model pair and serve a batch of requests across
the chosen mode (port of ``repro/launch/serve.py``: the same flags,
defaults and JSON summary).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode synera \
      --budget 0.2 --requests 8 --max-new 48 --concurrency 4

Weights: ``--ckpt DIR`` (default ``results/ckpt``) holds the tiny pair's
``tiny-slm.npz`` / ``tiny-llm.npz`` as the reference's
``checkpoint/io.py`` writes them (the port's ``python -m
repro_torch.launch.train`` or the reference's ``python -m
benchmarks.prepare`` trains and saves them); a missing checkpoint raises.  ``--random-weights``
instead draws both models with ``models.model.init_params`` from
``--seed`` (SLM) and ``--seed + 1`` (LLM).  ``--device`` (default
``cuda``) names the card; without one the launcher raises unless
``--device cpu`` is given.  ``--attn-impl pallas`` dispatches the port's
hand-written CUDA kernels.

Modes: synera | edge | cloud | hybrid | edgefm.

``--concurrency N`` (synera/hybrid) serves N device streams at once
through the SyneraServer event loop so cloud verify iterations pack
chunks from multiple slots; ``--concurrency 0`` means unbounded.
``--arrival-rate R`` draws Poisson request arrivals at R req/s on the
shared simulated clock (default: all streams arrive at admission).

``--replicas N`` (synera mode) serves the batch across N independent
cloud replicas behind a ``ReplicaRouter`` (serving/router.py); each
admission is placed by ``--route-policy`` (round-robin / least-loaded /
prefix-affinity) and token streams stay byte-identical to the
single-replica run.  Composes with ``--http``.

``--http`` instead brings up the OpenAI-compatible streaming gateway
(serving/gateway/, docs/serving_api.md) over the same engine + device
pair and serves real sockets until interrupted:

  PYTHONPATH=src python -m repro_torch.launch.serve --http --port 8711 \
      --budget 0.2 --max-active 4 --queue-cap 8

The gateway runs on a wall clock (``RealClock``): requests are served
as fast as the host allows while the modeled schedule accumulates
shadow time for the modeled-vs-real cross-check on /metrics;
``--wall-pace`` instead sleeps through modeled costs so wall-clock
latencies track the modeled schedule.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

CKPT_DIR = "results/ckpt"   # the reference's benchmarks/prepare.CKPT_DIR
VOCAB = 64                  # the reference's benchmarks/prepare.VOCAB


def load_pair(ckpt_dir: str, *, random_weights: bool, seed: int,
              device=None):
    """The tiny SLM/LLM pair and its synthetic task, as the reference's
    ``benchmarks/prepare.get_pair`` returns them: loaded from
    ``ckpt_dir`` or, with ``random_weights``, drawn from ``seed``."""
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.configs.synera_pair import tiny_pair
    from repro_torch.data.synthetic import SyntheticTask, TaskSpec
    from repro_torch.models import model as M

    slm_cfg, llm_cfg = tiny_pair(vocab=VOCAB)
    task = SyntheticTask(TaskSpec(vocab=VOCAB))
    params = []
    for i, cfg in enumerate((slm_cfg, llm_cfg)):
        if random_weights:
            params.append(M.init_params(cfg, seed + i, device=device))
            continue
        path = os.path.join(ckpt_dir, f"{cfg.name}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint {path}: train and save the pair with the "
                f"port (PYTHONPATH=src python -m repro_torch.launch.train "
                f"--model {cfg.name} --out {path}) or the reference "
                f"(PYTHONPATH=src:. python -m benchmarks.prepare), point "
                f"--ckpt at it, or pass --random-weights")
        params.append(ckpt.load(path, cfg, device=device))
    return slm_cfg, params[0], llm_cfg, params[1], task


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), serve, print the summary
    and return it (``None`` under ``--http``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="synera",
                    choices=["synera", "edge", "cloud", "hybrid", "edgefm"])
    ap.add_argument("--budget", type=float, default=0.2)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=40)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--bandwidth-mbps", type=float, default=10.0)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--concurrency", type=int, default=1,
                    help="concurrent device sessions (0 = unbounded)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals in requests/s of simulated "
                         "time (0 = arrive at admission)")
    ap.add_argument("--attn-impl", default=None,
                    choices=["naive", "blocked", "pallas"],
                    help="cloud+device attention implementation; "
                         "'pallas' dispatches the hand-written CUDA "
                         "kernels (decode_gqa / partial_prefill / "
                         "attn_importance; their plain versions for "
                         "CPU tensors)")
    ap.add_argument("--verify-top-k", type=int, default=8,
                    help="top-k sampling support the fused verification "
                         "epilogue keeps device-side per row (the only "
                         "distribution state that crosses to the host)")
    ap.add_argument("--cache-impl", default=None,
                    choices=["dense", "paged"],
                    help="cloud KV cache layout: 'dense' reserves slots x "
                         "s_max up front; 'paged' backs slots with a "
                         "shared block pool + block tables so memory "
                         "scales with live sequence lengths and the "
                         "scheduler admits/preempts by free blocks")
    ap.add_argument("--block-size", type=int, default=None,
                    help="tokens per KV block (paged cache; must divide "
                         "the engine s_max)")
    ap.add_argument("--block-kv", type=int, default=None,
                    help="paged kernels only (--cache-impl paged "
                         "--attn-impl pallas): KV tokens per reference "
                         "grid step; with --kv-splits it decides where "
                         "each split starts (kernels/paged.fused_layout) "
                         "(unset: cfg.paged_block_kv)")
    ap.add_argument("--kv-splits", type=int, default=None,
                    help="paged kernels only: flash-decode "
                         "split-KV — partition the sequence axis into N "
                         "parallel splits whose online-softmax partials "
                         "are merged by an epilogue; 1 is bit-"
                         "identical to the single-pass kernel (unset: "
                         "cfg.paged_kv_splits)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="total blocks in the paged pool (default: dense "
                         "capacity, slots x s_max / block-size; smaller "
                         "pools trade memory for preemptions)")
    ap.add_argument("--swap", action="store_true", default=None,
                    help="paged cache only: enable the host-memory KV "
                         "swap tier — preempted streams are gathered to "
                         "host RAM and restored later instead of "
                         "recompute-eviction when the modeled D2H+H2D "
                         "round trip beats the modeled re-prefill "
                         "(unset: cfg.kv_swap)")
    ap.add_argument("--host-swap-blocks", type=int, default=None,
                    help="host swap store capacity in KV blocks "
                         "(0 = unbounded; unset: cfg.host_swap_blocks); "
                         "victims that do not fit fall back to "
                         "recompute-eviction")
    ap.add_argument("--preempt-policy", default=None,
                    choices=["youngest", "most-blocks", "slo-aware"],
                    help="eviction victim selection when the paged pool "
                         "runs dry: youngest admitted stream (the "
                         "cfg.preempt_policy default), largest freeable "
                         "block holder, or the stream with the most "
                         "remaining TTFT/deadline slack")
    ap.add_argument("--share-prefix", action="store_true",
                    help="paged cache only: dedupe identical leading "
                         "full prompt blocks across streams (ref-counted "
                         "blocks, copy-on-write on divergent writes)")
    ap.add_argument("--retain-prefix", action="store_true", default=None,
                    help="paged cache only (implies --share-prefix): "
                         "keep released ref-0 prefix blocks on a "
                         "cached-free LRU so later sessions with the "
                         "same prompt prefix adopt them without "
                         "recompute (unset: cfg.retain_prefix)")
    ap.add_argument("--retain-blocks", type=int, default=None,
                    help="cached-free LRU capacity in KV blocks "
                         "(0 = unbounded; unset: cfg.retain_blocks)")
    ap.add_argument("--no-host-dedupe", action="store_false",
                    dest="host_dedupe", default=None,
                    help="disable the content-addressed host store "
                         "(with --swap + prefix sharing the host tier "
                         "dedupes identical swapped prefixes and new "
                         "sessions adopt matching host blocks; unset: "
                         "cfg.host_dedupe)")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="prepend a common synthetic system prefix of N "
                         "tokens to every request (exercises prefix "
                         "sharing; task quality scores still use the "
                         "unmodified prompts, so treat them as a smoke "
                         "signal only)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="cloud replicas behind a ReplicaRouter (each an "
                         "independent engine + scheduler with its own "
                         "block pool / prefix index / swap tier); 1 = "
                         "no router (synera mode and --http only)")
    ap.add_argument("--route-policy", default="least-loaded",
                    choices=["round-robin", "least-loaded",
                             "prefix-affinity"],
                    help="fleet placement policy (--replicas > 1): "
                         "rotate, fewest live sessions / most free "
                         "blocks, or the replica whose prefix cache "
                         "already holds the longest prefix of the prompt")
    ap.add_argument("--replica-queue-cap", type=int, default=0,
                    help="live sessions per replica before it counts as "
                         "saturated; when ALL replicas are past it, new "
                         "streams degrade to device-only generation "
                         "instead of rejecting (0 = unbounded)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--http", action="store_true",
                    help="serve the OpenAI-compatible streaming HTTP "
                         "gateway instead of a fixed batch (synera mode "
                         "only; runs until interrupted)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8711,
                    help="gateway port (0 = ephemeral)")
    ap.add_argument("--max-active", type=int, default=4,
                    help="gateway: concurrent streams in the serving "
                         "loop; beyond this, accepted requests queue")
    ap.add_argument("--queue-cap", type=int, default=8,
                    help="gateway: accepted-but-waiting requests beyond "
                         "--max-active before new ones get 429 + "
                         "Retry-After")
    ap.add_argument("--wall-pace", action="store_true",
                    help="gateway: sleep through modeled costs so "
                         "wall-clock latencies track the modeled "
                         "schedule (default: serve at host speed, "
                         "modeled time as a shadow cross-check)")
    ap.add_argument("--trace", action="store_true",
                    help="attach the unified tracer (serving/trace.py): "
                         "per-stream lifecycle spans + stall-time "
                         "attribution into /metrics and the summary; "
                         "token streams are byte-identical either way "
                         "(synera/hybrid modes; also --http, where the "
                         "gateway serves /v1/traces)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the Perfetto/Chrome trace-event JSON to "
                         "PATH after the run (implies --trace); load it "
                         "at ui.perfetto.dev")
    ap.add_argument("--ckpt", default=CKPT_DIR, metavar="DIR",
                    help="directory of the tiny pair's checkpoints "
                         "(tiny-slm.npz, tiny-llm.npz); make them with "
                         "python -m repro_torch.launch.train or the "
                         "reference's python -m benchmarks.prepare")
    ap.add_argument("--random-weights", action="store_true",
                    help="draw both models from --seed instead of "
                         "loading --ckpt")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (raises without a "
                         "card unless 'cpu' is given)")
    args = ap.parse_args(argv)
    trace_on = args.trace or bool(args.trace_out)
    if args.concurrency < 0:
        ap.error("--concurrency must be >= 0 (0 = unbounded)")
    if args.http and args.mode != "synera":
        ap.error("--http serves the synera pipeline (--mode synera)")
    if trace_on and args.mode not in ("synera", "hybrid"):
        ap.error("--trace/--trace-out require --mode synera or hybrid "
                 "(only the SyneraServer event loop is instrumented)")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.replicas > 1 and args.mode != "synera":
        ap.error("--replicas > 1 requires --mode synera (the fleet "
                 "router places synera sessions)")

    from repro_torch.core.offload import OffloadPolicy
    from repro_torch.launch import evalset as PC
    from repro_torch.runtime import resolve_device
    from repro_torch.serving import synergy as SY
    from repro_torch.serving.link import LinkModel

    device = resolve_device(args.device)
    slm_cfg, slm_p, llm_cfg, llm_p, task = load_pair(
        args.ckpt, random_weights=args.random_weights, seed=args.seed,
        device=device)
    if args.attn_impl is not None:
        slm_cfg = slm_cfg.replace(attn_impl=args.attn_impl)
    evalset = PC.eval_set(task, args.requests, seed=args.seed + 7)
    prompts = [p for p, _ in evalset]
    if args.shared_prefix_tokens > 0:
        rng = np.random.default_rng(args.seed + 29)
        common = [int(t) for t in rng.integers(
            1, slm_cfg.vocab - 1, args.shared_prefix_tokens)]
        prompts = [common + list(p) for p in prompts]
    link = LinkModel(bandwidth_mbps=args.bandwidth_mbps)
    if args.swap and args.cache_impl != "paged":
        ap.error("--swap requires --cache-impl paged")
    def mk_engine():
        return PC.make_engine(llm_cfg, llm_p, slots=args.slots,
                              attn_impl=args.attn_impl,
                              verify_top_k=args.verify_top_k,
                              cache_impl=args.cache_impl,
                              block_size=args.block_size,
                              pool_blocks=args.pool_blocks,
                              share_prefix=args.share_prefix,
                              swap=args.swap,
                              host_swap_blocks=args.host_swap_blocks,
                              retain_prefix=args.retain_prefix,
                              retain_blocks=args.retain_blocks,
                              host_dedupe=args.host_dedupe,
                              paged_block_kv=args.block_kv,
                              kv_splits=args.kv_splits,
                              device=device)

    eng = mk_engine()
    # fleet mode: replica 0 reuses `eng` (also the profiling target);
    # the rest are independent engines with their own pools and caches
    engines = ([eng] + [mk_engine() for _ in range(args.replicas - 1)]
               if args.replicas > 1 else [eng])
    concurrency = None if args.concurrency == 0 else args.concurrency
    arrivals = None
    if args.arrival_rate > 0:
        rng = np.random.default_rng(args.seed + 13)
        gaps = rng.exponential(1e3 / args.arrival_rate, len(prompts))
        arrivals = np.cumsum(gaps).tolist()

    if args.share_prefix and args.cache_impl != "paged":
        print("warning: --share-prefix requires --cache-impl paged; "
              "ignored on the dense cache", file=sys.stderr)
    if args.mode not in ("synera", "hybrid") and (args.concurrency != 1
                                                  or arrivals is not None):
        print(f"warning: --concurrency/--arrival-rate only apply to "
              f"synera/hybrid; ignored for --mode {args.mode}",
              file=sys.stderr)

    if args.mode in ("synera", "hybrid", "edgefm"):
        dev0 = PC.make_device(slm_cfg, slm_p, link=link, gamma=args.gamma,
                              seed=args.seed, device=device)
        profile, _ = PC.profile_pair(dev0, eng, evalset, task)
        pol = OffloadPolicy(c_th=profile.c_th,
                            i_th=profile.i_th_for_budget(args.budget),
                            mode="both")
        dev = PC.make_device(slm_cfg, slm_p, policy=pol, link=link,
                             gamma=args.gamma, seed=args.seed,
                             alpha=profile.alpha, device=device)
    else:
        dev = PC.make_device(slm_cfg, slm_p, link=link, gamma=args.gamma,
                             seed=args.seed,
                             policy=OffloadPolicy(mode="none"),
                             device=device)

    if args.http:
        from repro_torch.serving.gateway import Gateway, GatewayConfig
        from repro_torch.serving.link import RealClock
        from repro_torch.serving.server import SyneraServer, build_fleet
        from repro_torch.serving.trace import Tracer
        clock = RealClock(pace=args.wall_pace)
        tracer = Tracer(clock) if trace_on else None
        if args.replicas > 1:
            from repro_torch.serving.router import ReplicaRouter
            servers = build_fleet(dev, engines, clock=clock,
                                  preempt_policy=args.preempt_policy,
                                  clamp_arrivals=not args.wall_pace,
                                  tracer=tracer)
            server = ReplicaRouter(servers, policy=args.route_policy,
                                   replica_queue_cap=args.replica_queue_cap)
        else:
            server = SyneraServer(dev, eng, clock=clock,
                                  preempt_policy=args.preempt_policy,
                                  clamp_arrivals=not args.wall_pace,
                                  tracer=tracer)
        Gateway(server, GatewayConfig(
            host=args.host, port=args.port,
            max_new_default=args.max_new,
            max_active=args.max_active,
            queue_cap=args.queue_cap)).run_forever()
        if args.trace_out and tracer is not None:
            print(f"trace written to {tracer.export(args.trace_out)}",
                  file=sys.stderr)
        return

    def run_synera_batch():
        if args.replicas > 1:
            return SY.run_synera_fleet(
                dev, engines, prompts, args.max_new,
                policy=args.route_policy,
                replica_queue_cap=args.replica_queue_cap,
                concurrency=concurrency, arrivals=arrivals,
                preempt_policy=args.preempt_policy, trace=trace_on)
        return SY.run_synera(dev, eng, prompts, args.max_new,
                             concurrency=concurrency, arrivals=arrivals,
                             preempt_policy=args.preempt_policy,
                             trace=trace_on)

    run = {
        "synera": run_synera_batch,
        "edge": lambda: SY.run_edge_centric(dev, prompts, args.max_new),
        "cloud": lambda: SY.run_cloud_centric(eng, prompts, args.max_new,
                                              link=link),
        "hybrid": lambda: SY.run_hybrid(dev, eng, prompts, args.max_new,
                                        concurrency=concurrency,
                                        arrivals=arrivals,
                                        preempt_policy=args.preempt_policy,
                                        trace=trace_on),
        "edgefm": lambda: SY.run_edgefm(dev, eng, prompts, args.max_new,
                                        link=link),
    }[args.mode]
    r = run()
    s = PC.score_outputs(task, evalset, r.outputs)
    # digest of all token streams: two runs served identically (e.g. a
    # roomy pool vs one forced to swap) must agree byte-for-byte
    sha = hashlib.sha256(
        json.dumps([[int(t) for t in o] for o in r.outputs]).encode()
    ).hexdigest()[:16]
    summary = dict(mode=args.mode, n=len(prompts), quality=s["quality"],
                   copy_acc=s["copy_acc"], tbt_ms=r.tbt_ms, cost=r.cost,
                   cloud_token_frac=r.cloud_token_frac, outputs_sha=sha)
    sched = r.extras.get("scheduler")
    if sched is not None:
        summary.update(
            concurrency=args.concurrency,
            verify_occupancy=sched["mean_verify_occupancy"],
            packed_tokens=sched["mean_packed_tokens"],
            iterations=sched["iterations"],
            # same ServerStats fields the gateway's /metrics exposes
            completed_streams=sched["completed_streams"],
            ttft_ms_p50=sched["ttft_ms_p50"],
            ttft_ms_p95=sched["ttft_ms_p95"],
            e2e_ms_p50=sched["e2e_ms_p50"],
            e2e_ms_p95=sched["e2e_ms_p95"])
        if sched.get("cache_impl") == "paged":
            summary.update(
                cache_impl="paged",
                block_size=sched["block_size"],
                blocks_used_peak=(f"{sched['peak_used_blocks']}"
                                  f"/{sched['n_blocks']}"),
                kv_bytes_peak=sched["kv_bytes_peak"],
                kv_cache_bytes=sched["kv_cache_bytes"],
                preemptions=sched["preemptions"],
                preempt_policy=sched["preempt_policy"],
                swap=sched["swap"],
                recompute_evictions=sched["recompute_evictions"],
                swap_evictions=sched["swap_evictions"],
                swapped_blocks=sched["swapped_blocks"],
                swap_out_bytes=sched["swap_out_bytes"],
                swap_in_bytes=sched["swap_in_bytes"],
                preempted_refed_tokens=sched["preempted_refed_tokens"],
                share_prefix=sched["share_prefix"],
                dedupe_hit_blocks=sched["dedupe_hit_blocks"],
                cow_copies=sched["cow_copies"],
                retain_prefix=sched["retain_prefix"],
                cached_free_blocks=sched["cached_free_blocks"],
                revived_blocks=sched["revived_blocks"],
                reclaimed_blocks=sched["reclaimed_blocks"],
                tail_shared_tokens=sched["tail_shared_tokens"],
                host_adopted_blocks=sched["host_adopted_blocks"],
                admission_swaps=sched["admission_swaps"],
                prefill_fed_tokens=sched["prefill_fed_tokens"])
        if sched.get("replicas", 1) > 1:
            summary.update(
                replicas=sched["replicas"],
                route_policy=sched["route_policy"],
                affinity_hits=sched["affinity_hits"],
                degraded_streams=sched["degraded_streams"],
                rerouted_sessions=sched["rerouted_sessions"],
                dead_replicas=sched["dead_replicas"])
        if sched.get("trace"):
            summary.update(
                trace=True,
                stall_wall_ms=sched["stall_wall_ms"],
                stall_device_ms=sched["stall_device_ms"],
                stall_cloud_ms=sched["stall_cloud_ms"],
                stall_link_ms=sched["stall_link_ms"],
                stall_queue_ms=sched["stall_queue_ms"],
                stall_batch_wait_ms=sched["stall_batch_wait_ms"],
                stall_swap_ms=sched["stall_swap_ms"],
                stall_preempted_ms=sched["stall_preempted_ms"],
                stall_other_ms=sched["stall_other_ms"])
    summary.update(
        engine_host_bytes=eng.bytes_to_host,
        engine_specializations=eng.compile_stats["n_specializations"])
    if args.trace_out:
        tracer = r.extras.get("tracer")
        if tracer is not None:
            summary["trace_out"] = tracer.export(args.trace_out)
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k:18s} {v}")
    return summary


if __name__ == "__main__":
    main()
