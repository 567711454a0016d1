"""Serving launcher: run the port's LLMEngine, or its disaggregated
cluster, on a synthetic trace. Port of ``repro/launch/serve.py``: the same
flags and summary lines, minus ``--backend`` (the port has no decode
backend knob: the device decides) and plus ``--device`` (default
``cuda``; ``--device cpu`` runs the kernels' plain twins on the CPU).
``--arch`` takes every arch of the registry of the dense, vlm and moe
families (``--placement moe_offload`` with ``--expert-workers`` puts a moe
model's experts on their own pool and prints its transfer line); an
audio, ssm or hybrid arch exits with the engine's family error.

  repro-torch-serve --arch llama3-8b --smoke --placement attention_pool \
      --trace azure-conv --requests 16 --device cpu

  (or: PYTHONPATH=src python -m repro_torch.launch.serve ...)

``--mode`` selects the deployment role (serving/cluster/):

  * ``engine``  — the unified single engine (default, the path above);
  * ``router``  — a full disaggregated cluster: ``--replicas`` paired
    prefill/decode engines behind the prefix-affinity router
    (``--routing``), KV handed off block-granularly at
    ``--transfer-blocks-per-step`` blocks per step;
  * ``prefill`` — a standalone prefill tier: admit + prefill + export
    only, handoff payloads drained from the outbox (reports export
    volume and retained prefix donors);
  * ``decode``  — a standalone decode tier fed by an in-process prefill
    feeder (the transport seam a real RPC fabric would replace); reports
    the transfer/handoff-latency surface.

Fault injection (``--fault-scenario``) attaches a deterministic, seeded
fault schedule at the attention-pool boundary — shard death / transient /
corrupt / straggle — and the run reports the recovery counters and
recovery-latency percentiles (in router mode the schedule attaches to
decode replica 0 — the transfer-interruption path). Ctrl-C shuts down
gracefully: in-flight requests are cancelled (partial outputs kept) and
the stats summary always prints.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--mode", default="engine",
                    choices=["engine", "prefill", "decode", "router"],
                    help="deployment role: unified engine (default), "
                         "standalone prefill/decode tier, or the routed "
                         "disaggregated cluster")
    ap.add_argument("--replicas", type=int, default=2,
                    help="prefill/decode replica pairs (--mode router)")
    ap.add_argument("--routing", default="affinity",
                    choices=["affinity", "random", "least_loaded"],
                    help="request routing policy (--mode router)")
    ap.add_argument("--affinity-blocks", type=int, default=2,
                    help="leading full prompt blocks hashed into the "
                         "prefix-affinity routing key")
    ap.add_argument("--transfer-blocks-per-step", type=int, default=8,
                    help="KV blocks a decode replica lands per engine "
                         "step while draining its transfer queue "
                         "(0 = a whole payload per step)")
    ap.add_argument("--no-retain-prefixes", action="store_true",
                    help="free exported prompts immediately instead of "
                         "retaining them as prefix-sharing donors")
    ap.add_argument("--placement", default="attention_pool",
                    choices=["homogeneous", "attention_pool", "moe_offload"])
    ap.add_argument("--engine", default=None, choices=["vllm", "lamina"],
                    help="legacy alias: vllm=homogeneous, "
                         "lamina=attention_pool (overrides --placement)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace", default="azure-conv")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--scale", type=float, default=0.02,
                    help="trace length scale (CPU-friendly)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=512)
    ap.add_argument("--attention-workers", type=int, default=2)
    ap.add_argument("--expert-workers", type=int, default=2)
    ap.add_argument("--partition", default="head",
                    choices=["head", "block", "request"])
    ap.add_argument("--scheduler", default="fcfs",
                    choices=["fcfs", "preempt"])
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="refcounted prompt-prefix sharing: map identical "
                         "full prompt blocks onto one set of physical KV "
                         "blocks (copy-on-write on divergence) and skip "
                         "their prefill")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="chunked paged prefill: per-iteration prefill "
                         "token budget (a multiple of the block size; at "
                         "most one chunk runs per engine step alongside "
                         "the full decode batch). 0 = one-shot prefill")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="KV block pool storage dtype: bf16 (the model "
                         "dtype) or int8 with per-token per-kv-head fp32 "
                         "scales — ~2x pool residency and decode KV-read "
                         "bytes, dequant fused into the attention kernels "
                         "(applies to every mode incl. prefill/decode/"
                         "router tiers; both tiers of a disaggregated "
                         "pair must agree)")
    ap.add_argument("--events", action="store_true",
                    help="print the iteration-level lifecycle event stream")
    ap.add_argument("--kv-shards", type=int, default=0,
                    help="shard the KV pool's block axis over this many "
                         "pool shards (0 = derive: block partition shards "
                         "over the attention workers, otherwise 1). Fault "
                         "injection targets these shards")
    ap.add_argument("--fault-scenario", default=None,
                    help="deterministic fault schedule at the pool "
                         "boundary: inline DSL "
                         "'kind:key=val,...;kind:...' (kinds: shard_death "
                         "| transient | corrupt | straggle; keys: shard, "
                         "step, failures, rejoin, delay_ms) or a path to "
                         "a JSON scenario file")
    ap.add_argument("--fault-retry-limit", type=int, default=3,
                    help="failed probes / corrupted outputs a shard may "
                         "accumulate before being declared dead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where weights, pools and kernels live: cuda "
                         "(the CUDA kernels and graphs) or cpu (their "
                         "plain twins)")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.data import traces
    from repro_torch.models import transformer
    from repro_torch.serving import (EngineConfig, FaultInjector,
                                     FaultScenario, LLMEngine)

    placement = {"vllm": "homogeneous", "lamina": "attention_pool",
                 None: args.placement}[args.engine]
    cfg = registry.get_smoke_config(args.arch) if args.smoke \
        else registry.get_config(args.arch)
    try:     # the engine serves the KV-cache archs of the registry
        transformer._check_family(cfg, f"serving --arch {args.arch}")
    except NotImplementedError as e:
        ap.error(str(e))
    reqs = traces.generate(args.trace, args.requests, cfg.vocab_size,
                           scale=args.scale, seed=args.seed)
    econf = EngineConfig(
        placement=placement, partition=args.partition,
        attention_workers=args.attention_workers,
        expert_workers=args.expert_workers,
        max_batch=args.max_batch, num_blocks=args.num_blocks,
        kv_shards=args.kv_shards or None,
        scheduler=args.scheduler, kv_dtype=args.kv_dtype,
        prefix_sharing=args.prefix_sharing,
        prefill_chunk_tokens=args.prefill_chunk_tokens or None,
        fault_retry_limit=args.fault_retry_limit,
        seed=args.seed)
    params = transformer.init_params(args.seed, cfg, device=args.device)
    injector = None
    if args.fault_scenario:
        injector = FaultInjector(FaultScenario.parse(args.fault_scenario))

    if args.mode != "engine":
        _run_disagg(args, cfg, params, econf, reqs, injector)
        return

    eng = LLMEngine(cfg, params, econf, fault_injector=injector,
                    device=args.device)
    eng.submit(reqs)
    # graceful shutdown: Ctrl-C cancels the in-flight requests (pool blocks
    # freed, partial outputs kept, handle iterators terminate) and the
    # stats summary below ALWAYS prints — an interrupted run still reports
    try:
        if args.events:
            for ev in eng.events():  # events() drives the engine to drain
                print(f"  step {ev.step:4d} {ev.kind:8s} rid={ev.rid} "
                      f"{ev.info}")
        else:
            eng.run()
    except KeyboardInterrupt:
        n = eng.cancel_all()
        print(f"\ninterrupted — cancelled {n} in-flight request(s), "
              f"partial outputs kept; draining stats")
    s = eng.stats.summary()
    print(f"placement={placement} partition={args.partition} "
          f"scheduler={args.scheduler} trace={args.trace} "
          f"requests={len(reqs)} tokens={s['tokens_generated']} "
          f"mean_batch={s['mean_batch']:.2f} "
          f"throughput={s['throughput_tok_s']:.1f} tok/s "
          f"mean_tbt={s['mean_tbt_s']*1000:.1f} ms "
          f"preemptions={s['preemptions']}")
    if args.prefill_chunk_tokens:
        print(f"chunked_prefill chunk_tokens={args.prefill_chunk_tokens} "
              f"prefill_chunks_run={s['prefill_chunks_run']} "
              f"max_prefill_slab_tokens={s['max_prefill_slab_tokens']}")
    if args.kv_dtype != "bf16":
        print(f"kv_pool dtype={args.kv_dtype} "
              f"resident_bytes={s['kv_pool_bytes_resident']} "
              f"read_bytes_per_step={s['kv_bytes_read_per_step']:.0f}")
    if args.prefix_sharing:
        print(f"prefix_sharing blocks_shared={s['blocks_shared']} "
              f"prefill_tokens_skipped={s['prefill_tokens_skipped']} "
              f"cow_forks={eng.kv.cow_forks} "
              f"used_blocks={eng.kv.used_blocks}")
    if args.fault_scenario or s["shard_failures"] or s["fault_retries"]:
        print(f"faults shard_failures={s['shard_failures']} "
              f"rejoins={s['shard_rejoins']} "
              f"transient_recovered={s['transient_faults_recovered']} "
              f"retries={s['fault_retries']} "
              f"straggles={s['straggle_steps']} "
              f"requests_recovered={s['requests_recovered']}")
        print(f"recovery_ms p50={s['recovery_p50_s']*1e3:.1f} "
              f"p90={s['recovery_p90_s']*1e3:.1f} "
              f"p99={s['recovery_p99_s']*1e3:.1f}")
    print(f"ttft_ms p50={s['ttft_p50_s']*1e3:.1f} "
          f"p90={s['ttft_p90_s']*1e3:.1f} p99={s['ttft_p99_s']*1e3:.1f}  "
          f"tbt_ms p50={s['tbt_p50_s']*1e3:.1f} "
          f"p90={s['tbt_p90_s']*1e3:.1f} p99={s['tbt_p99_s']*1e3:.1f}")
    if eng.pool is not None:
        log = eng.pool.log
        print(f"pool transfers={log.transfers} bytes={log.total} "
              f"(q={log.q_bytes} kv={log.kv_bytes} out={log.out_bytes})")
        print(f"pool partition={args.partition} per_worker_kv_bytes="
              f"{eng.pool.per_worker_kv_bytes}")
    if eng.expert_pool is not None:
        elog = eng.expert_pool.log
        print(f"expert pool transfers={elog.transfers} bytes={elog.total}")


def _run_disagg(args, cfg, params, econf, reqs, injector) -> None:
    """The disaggregated roles: standalone prefill / decode tier, or the
    full routed cluster (--mode router)."""
    from repro_torch.serving import DisaggConfig
    from repro_torch.serving.cluster import (DecodeEngine, DisaggCluster,
                                             PrefillEngine)

    disagg = DisaggConfig(
        transfer_blocks_per_step=args.transfer_blocks_per_step,
        retain_prefixes=not args.no_retain_prefixes)

    if args.mode == "router":
        cluster = DisaggCluster(
            cfg, params, econf, replicas=args.replicas,
            disagg=disagg, routing=args.routing,
            affinity_blocks=args.affinity_blocks,
            decode_faults={0: injector} if injector else None,
            seed=args.seed, device=args.device)
        cluster.submit(reqs)
        try:
            cluster.run()
        except KeyboardInterrupt:
            print("\ninterrupted — reporting partial cluster stats")
        s = cluster.summary()
        print(f"mode=router replicas={s['replicas']} "
              f"routing={s['routing']} requests={s['requests']} "
              f"tokens={s['tokens_generated']} "
              f"handoffs={s['handoffs_completed']} "
              f"retries={s['handoff_retries']}")
        print(f"router affinity_hits={s['router_affinity_hits']} "
              f"prefill_tokens_skipped={s['prefill_tokens_skipped']} "
              f"blocks_shared={s['blocks_shared']}")
        print(f"kv_bytes_transferred={s['kv_bytes_transferred']} "
              f"handoff_ms p50={s['handoff_p50_s']*1e3:.1f} "
              f"p90={s['handoff_p90_s']*1e3:.1f} "
              f"p99={s['handoff_p99_s']*1e3:.1f}")
        for p in s["per_replica"]:
            print(f"  replica {p['replica']}: healthy={p['healthy']} "
                  f"handoffs={p['handoffs_completed']} "
                  f"kv_bytes={p['kv_bytes_transferred']} "
                  f"affinity_hits={p['router_affinity_hits']} "
                  f"skipped={p['prefill_tokens_skipped']}")
        return

    if args.mode == "prefill":
        eng = PrefillEngine(cfg, params, econf,
                            disagg=disagg.replace(role="prefill"),
                            fault_injector=injector, device=args.device)
        eng.submit(reqs)
        exported = []
        while eng.has_work():
            eng.step()
            exported.extend(eng.collect_handoffs())
        s = eng.stats
        print(f"mode=prefill requests={len(reqs)} "
              f"exported={len(exported)} "
              f"kv_bytes_exported={s.kv_bytes_transferred} "
              f"payload_blocks={sum(h.payload.n_blocks for h in exported)} "
              f"retained_donors={len(eng.retained_rids)} "
              f"prefill_tokens_skipped={s.prefill_tokens_skipped}")
        return

    # --mode decode: an in-process prefill feeder plays the remote tier
    feeder = PrefillEngine(cfg, params, econf,
                           disagg=disagg.replace(role="prefill"),
                           device=args.device)
    eng = DecodeEngine(cfg, params, econf,
                       disagg=disagg.replace(role="decode"),
                       fault_injector=injector, device=args.device)
    feeder.on_handoff = eng.enqueue_handoff
    feeder.submit(reqs)
    while feeder.has_work() or eng.has_work():
        if feeder.has_work():
            feeder.step()
        if eng.has_work():
            eng.step()
    s = eng.stats.summary()
    print(f"mode=decode requests={len(reqs)} "
          f"tokens={s['tokens_generated']} "
          f"handoffs={s['handoffs_completed']} "
          f"retries={s['handoff_retries']} "
          f"kv_bytes_transferred={s['kv_bytes_transferred']} "
          f"max_prefill_slab_tokens={s['max_prefill_slab_tokens']}")
    print(f"handoff_ms p50={s['handoff_p50_s']*1e3:.1f} "
          f"p90={s['handoff_p90_s']*1e3:.1f} "
          f"p99={s['handoff_p99_s']*1e3:.1f}  "
          f"tbt_ms p50={s['tbt_p50_s']*1e3:.1f} "
          f"p90={s['tbt_p90_s']*1e3:.1f}")


if __name__ == "__main__":
    main()
