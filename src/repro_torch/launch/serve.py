"""Serving launcher, a port of the reference's ``launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --service viterbi \
        --mode tiled --use-kernel [--device cpu]

Two services:
  * ``--service viterbi`` — the paper's workload: batched decode of LLR
    streams through the ``ViterbiDecoder`` front door (the optimized
    config with ``--optimized``).  ``--code`` picks any registry
    standard: punctured rates serve the serial kept-LLR stream;
    tail-biting codes (lte-tbcc) decode whole frames via WAVA, so they
    force ``--mode batch``.  ``--mode`` selects the decode scenario:
      - tiled   (default) stateless overlapping-window decode, every
        stream's windows folded into one window decode;
      - chunked stateful streaming: path metrics and a survivor ring
        carried across ``--chunk-len`` chunks;
      - sharded streams split over the shards of ``frame_mesh()`` (every
        card, or one CPU shard with ``--device cpu``);
      - batch   one truncated-Viterbi frame per stream;
      - time_parallel — the transfer-matrix scan decode of whole streams
        (the single-stream latency path; the same bits).
  * ``--service engine`` — the multi-tenant serving engine: ragged
    mixed-code requests bucketed into padded (F, T) cells, assembled
    under ``--max-wait-ms``/``--streams``, routed per SLO class
    (``--slo latency|throughput|mixed``), with queue-depth and
    backpressure stats and a graceful drain at the end.

  * ``--service lm`` — the LM testbed: the ``--arch`` smoke config,
    ``--streams`` prompts of 64 positions (a ``prefix_embeds`` stub for
    the frontend archs) prefilled through ``make_prefill_step``, then
    ``--tokens`` greedy steps through ``make_decode_step``, whose
    argument order ``(params, cache, tokens)`` this launcher keeps (the
    reference's ``serve_lm`` passes tokens and cache the other way
    round and crashes).

``--use-kernel`` keeps the reference's spelling and its path choice: with
it the streaming modes (tiled, chunked, sharded) take the one-pass path
(K2), without it the two-pass path.  On the card both paths launch
kernels: the decoder is always built with ``use_kernel=True`` and
``one_pass=--use-kernel``, so without the flag the windows and chunks
run through K1 and the plain traceback.  The engine service always
builds its engine with ``use_kernel=True`` (the reference passes
``--use-kernel``), so its throughput cells of ``STREAM_MIN_STEPS`` radix
steps or more take the stream route (K2) with or without the flag.  The
plain versions run only with ``--device cpu``, for CPU tensors.

Everything runs on the card unless ``--device cpu``.  LLRs come from
``ChannelStream`` (the viterbi service; its seed schedule) and from
``codes.standard_llrs`` on generators seeded by
``codes.simulate.batch_keys`` (the engine service).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

__all__ = ["serve_viterbi", "serve_engine", "serve_lm", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _viterbi_run_fn(vcfg, args):
    """Build run(llrs) -> bits for the selected ``--mode``."""
    from repro_torch.serve.step import make_viterbi_decoder, make_viterbi_serve_step

    one_pass = bool(getattr(args, "use_kernel", False))
    dev = args.device
    if args.mode in ("tiled", "batch"):
        return make_viterbi_serve_step(
            vcfg, mode=args.mode, one_pass=one_pass, device=dev)
    if args.mode == "chunked":
        decoder = make_viterbi_decoder(
            vcfg, decision_depth=args.decision_depth, one_pass=one_pass,
            device=dev)

        def run(llrs):
            return decoder.decode_stream_chunked(
                llrs, chunk_len=args.chunk_len, initial_state=None
            )

        return run
    if args.mode == "time_parallel":
        # the transfer-matrix scan decode of each whole stream: the same
        # bits, sequential depth about 3 tiles + log2(tiles) instead of T
        decoder = make_viterbi_decoder(vcfg, one_pass=one_pass, device=dev)

        def run(llrs):
            return decoder.decode_batch(
                llrs, initial_state=None, final_state=None,
                time_parallel=True,
            )

        return run
    if args.mode == "sharded":
        from repro_torch.distributed.decoder import (
            frame_mesh,
            sharded_decode_streams,
        )

        decoder = make_viterbi_decoder(vcfg, one_pass=one_pass, device=dev)
        mesh = frame_mesh(
            device=decoder.device if decoder.device.type == "cpu" else None)

        def run(llrs):
            # punctured streams: the erasures re-inserted first, then the
            # depunctured streams shard like any others
            llrs = decoder.depunctured(llrs)
            return sharded_decode_streams(
                llrs,
                vcfg.spec,
                cfg=decoder.default_tiled_config(vcfg.tiled),
                mesh=mesh,
                precision=vcfg.precision,
                pack_survivors=vcfg.pack_survivors,
                use_kernel=True,
                one_pass=one_pass,
            )

        run.mesh = mesh
        return run
    raise ValueError(f"unknown --mode {args.mode!r}")


def _viterbi_config(args):
    """The service config of ``--code`` and ``--optimized``, at the
    command line's stream shape; a tail-biting code sets ``args.mode`` to
    "batch"."""
    from repro_torch.codes.registry import get_code
    from repro_torch.configs.viterbi_k7 import (
        CONFIG,
        CONFIG_OPTIMIZED,
        config_for_standard,
    )

    if args.code != "ccsds-k7":
        # any registry standard behind the same front door
        vcfg = config_for_standard(args.code)
        if args.optimized:
            # apply exactly CONFIG -> CONFIG_OPTIMIZED's deltas, so a
            # retuned optimized config carries over to every standard
            vcfg = dataclasses.replace(vcfg, **{
                f.name: getattr(CONFIG_OPTIMIZED, f.name)
                for f in dataclasses.fields(CONFIG_OPTIMIZED)
                if f.name not in ("name", "family", "spec", "code")
                and getattr(CONFIG_OPTIMIZED, f.name)
                != getattr(CONFIG, f.name)
            })
        if get_code(args.code).termination == "tailbiting":
            args.mode = "batch"  # WAVA decodes frames whole
    else:
        vcfg = CONFIG_OPTIMIZED if args.optimized else CONFIG
    return dataclasses.replace(
        vcfg, stream_len=args.stream_len, batch_streams=args.streams
    )


def serve_viterbi(args) -> dict:
    """Decode ``--batches`` batches of ``--streams`` x ``--stream-len``
    streams after one warm-up call (which builds the kernels); print the
    reference's report line.  Returns the report: bits, errors, BER,
    seconds, Mb/s, the device count, and the last batch's (bits, llrs,
    decoded) for callers that hold the result to a direct call."""
    from repro_torch.core.backend import resolve_device
    from repro_torch.data.pipeline import ChannelStream

    dev = resolve_device(args.device)
    vcfg = _viterbi_config(args)
    run = _viterbi_run_fn(vcfg, args)
    src = ChannelStream(
        spec=vcfg.spec, n_streams=args.streams,
        stream_len=args.stream_len, ebn0_db=args.ebn0,
        code=args.code, device=dev,
    )
    bits, llrs = src.batch_at(0)
    run(llrs)  # warm-up: builds the kernels, allocates
    _sync(dev)
    total = err = 0
    t0 = time.perf_counter()
    for i in range(args.batches):
        bits, llrs = src.batch_at(i)
        out = run(llrs)
        _sync(dev)
        err += int((out != bits).sum())
        total += bits.numel()
    dt = time.perf_counter() - t0
    mesh = getattr(run, "mesh", None)
    n_dev = len(set(mesh.devices)) if mesh is not None else 1
    tag = f"viterbi-{args.mode}" + ("-opt" if args.optimized else "")
    print(
        f"[{tag}] {total} bits in "
        f"{dt:.2f}s = {total/dt/1e6:.2f} Mb/s "
        f"({n_dev} dev), BER={err/total:.3e}"
    )
    return dict(tag=tag, bits=total, errors=err, ber=err / total,
                seconds=dt, mbps=total / dt / 1e6, n_dev=n_dev,
                last=(bits, llrs, out))


def _engine_requests(args, tenants):
    """The reference's synthetic ragged workload: request b is tenant
    b % len(tenants)'s, of 128 bits (tail-biting) or a quarter, a third
    or a half of ``--stream-len`` (unflushed), drawn on the engine's
    device; its noise from a generator seeded with ``batch_keys``.
    Returns [(arrival, DecodeRequest, true bits)]."""
    from repro_torch.codes import encode_standard, get_code, standard_llrs
    from repro_torch.codes.simulate import batch_keys
    from repro_torch.core.backend import resolve_device
    from repro_torch.serve.engine import DecodeRequest

    dev = resolve_device(args.device)
    n_req = args.batches * args.streams
    keys = {name: batch_keys(0, name, args.ebn0, n_req) for name, _ in tenants}
    rng = np.random.default_rng(0)
    lens = [args.stream_len // 4, args.stream_len // 3, args.stream_len // 2]
    reqs = []  # (arrival, request, true bits)
    for b in range(n_req):
        code_name, slo = tenants[b % len(tenants)]
        code = get_code(code_name)
        n = 128 if code.termination == "tailbiting" else lens[b % len(lens)]
        bits = rng.integers(0, 2, (1, n))
        gen = torch.Generator(device=dev).manual_seed(keys[code_name][b])
        llrs = standard_llrs(
            gen,
            encode_standard(torch.as_tensor(bits, dtype=torch.int32, device=dev),
                            code),
            args.ebn0, code,
        )
        reqs.append((
            b * 1e-4,  # 10k offered req/s of virtual load
            DecodeRequest(llrs=llrs.cpu().numpy()[0], code=code_name, slo=slo),
            bits[0].astype(np.int32),
        ))
    return reqs


def serve_engine(args) -> dict:
    """Multi-tenant engine demo: a synthetic ragged mixed-code, mixed-SLO
    workload submitted against a virtual clock, polled tick by tick, then
    drained gracefully; prints decode throughput, BER, queue depth and
    backpressure, and the engine's occupancy, padding-waste and
    callable-cache counters.

    With ``--metrics-jsonl PATH`` the run records lifecycle spans (the
    decode stages, ``repro_torch.*``, nested under ``engine.dispatch``)
    and a final metrics snapshot to PATH (render it with ``python -m
    repro_torch.obs.top --jsonl PATH``), and the drain prints the
    Prometheus text dump.  With ``--chaos SCHEDULE.json`` the replay
    runs under the fault-injection harness (the JSON is a
    ``runtime.chaos.ChaosSchedule``); ``--checkpoint-dir DIR`` enables
    periodic session-table checkpoints, and the drain writes a final one
    and reports the failover stats.  ``--scrub-rate`` samples dispatches
    through the online SDC scrubber and the drain prints its summary.

    Returns the report: bits, errors, BER, dropped and errored requests,
    peak queue, seconds and the engine's ``stats()``."""
    from repro_torch.obs import (
        Observability,
        set_default_recorder,
        set_default_registry,
    )
    from repro_torch.serve.step import make_decode_engine

    if args.slo == "mixed":
        tenants = [
            ("ccsds-k7", "throughput"),
            (args.code if args.code != "ccsds-k7" else "wifi-11a-r34",
             "latency"),
            ("lte-tbcc", "latency"),
        ]
    else:
        tenants = [(args.code, args.slo)]
    obs = Observability(
        enabled=args.metrics_jsonl is not None, jsonl=args.metrics_jsonl
    )
    prev_reg = set_default_registry(obs.registry)  # decoder path counters
    # the decode stages nest under the engine's dispatch spans
    prev_rec = set_default_recorder(obs.recorder)
    chaos = None
    if args.chaos is not None:
        from repro_torch.runtime.chaos import ChaosInjector, ChaosSchedule

        chaos = ChaosInjector(ChaosSchedule.from_file(args.chaos))
    try:
        engine = make_decode_engine(
            use_kernel=True,
            device=args.device,
            max_batch=args.streams,
            max_wait={"latency": args.max_wait_ms / 4e3,
                      "throughput": args.max_wait_ms / 1e3},
            registry=obs.registry,
            recorder=obs.recorder,
            chaos=chaos,
            dispatch_timeout=0.1,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_interval=(
                None if args.checkpoint_dir is None else args.max_wait_ms / 1e3
            ),
            scrub=args.scrub_rate,
        )
        reqs = _engine_requests(args, tenants)
        t0 = time.perf_counter()
        tickets, peak_q = [], 0
        tick = args.max_wait_ms / 4e3
        now, i = 0.0, 0
        while i < len(reqs) or engine.queue_depth():
            while i < len(reqs) and reqs[i][0] <= now:
                tickets.append(engine.submit(reqs[i][1], now=now))
                i += 1
            engine.poll(now=now)
            peak_q = max(peak_q, engine.queue_depth())
            now += tick
        engine.drain(now=now)  # graceful drain: flush partial cells
        final_ckpt = engine.checkpoint_sessions(now=now)
        dt = time.perf_counter() - t0
        total = err = dropped = errored = 0
        for (_, _, bits), t in zip(reqs, tickets):
            if t.dropped:  # backpressure sheds, it does not corrupt BER
                dropped += 1
                continue
            if t.error is not None:  # typed errors, never silent drops
                errored += 1
                continue
            total += bits.size
            err += int((t.bits != bits).sum())
        s = engine.stats()
        lat = {k: f"p50={v['p50']*1e3:.2f}ms/p99={v['p99']*1e3:.2f}ms"
               for k, v in s["latency"].items()}
        print(
            f"[engine] {total} bits in {dt:.2f}s = {total/dt/1e6:.2f} Mb/s, "
            f"BER={err/max(total,1):.3e}\n"
            f"[engine] batches={s['batches']} occupancy={s['occupancy']:.2f} "
            f"padding_waste={s['padding_waste']:.2f} paths={s['paths']}\n"
            f"[engine] peak_queue={peak_q} rejected={s['rejected']} "
            f"dropped={dropped} jit_cache={s['jit_cache']} "
            f"latency(virtual)={lat}"
        )
        if args.chaos is not None or args.checkpoint_dir is not None:
            # the failover report of the graceful drain
            print(
                f"[engine] faults={s['faults']} retries={s['retries']} "
                f"degraded={s['degraded']} failovers={s['failovers']} "
                f"expired={s['expired']} failed={errored} "
                f"checkpoints={s['checkpoints']}"
            )
        if args.scrub_rate > 0:
            # the data-integrity quarantine summary of the drain
            sc = s["scrub"]
            print(
                f"[engine] scrub rate={sc['rate']} sampled={sc['sampled']} "
                f"frames={sc['frames']} flags={sc['syndrome_flags']} "
                f"confirmed={sc['confirmed']} "
                f"false_alarms={sc['false_alarms']} "
                f"quarantined={s['quarantined']} sanitized={s['sanitized']}"
            )
            if final_ckpt is not None:
                print(f"[engine] final session checkpoint -> {final_ckpt}")
        if args.metrics_jsonl is not None:
            # no metrics port to scrape: the Prometheus text goes to
            # stdout and the JSONL gets a final metrics snapshot line
            obs.close()
            print(engine.registry.render_prometheus(), end="")
            print(f"[engine] spans+metrics -> {args.metrics_jsonl}")
    finally:
        set_default_registry(prev_reg)
        set_default_recorder(prev_rec)
    return dict(bits=total, errors=err, ber=err / max(total, 1),
                dropped=dropped, errored=errored, peak_queue=peak_q,
                seconds=dt, stats=s, requests=len(reqs))


LM_PROMPT_LEN = 64  # positions of each prompt, prefix included


def serve_lm(args) -> dict:
    """Prefill ``--streams`` prompts of the ``--arch`` smoke config, then
    decode ``--tokens`` greedy steps; print the reference's report line
    with the device in place of "(CPU, reduced config)".  Parameters,
    prompts and prefix embeddings come from one CPU generator seeded 0.
    Returns the report: the config, the greedy tokens (B, tokens), the
    last logits, seconds and tokens/s."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.backend import resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    gen = torch.Generator().manual_seed(0)
    model = lm.LanguageModel.init(cfg, gen, dev)
    params = model.params
    B, S = args.streams, LM_PROMPT_LEN
    S_tok = S - cfg.prefix_len
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S_tok), generator=gen,
                                     dtype=torch.int32).to(dev)}
    if cfg.prefix_len:
        batch["prefix_embeds"] = (0.02 * torch.randn(
            (B, cfg.prefix_len, cfg.d_model), generator=gen)).to(
            device=dev, dtype=torch.bfloat16)
    cache = model.init_cache(B, max_len=S + args.tokens)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, cache, batch)
    nxt = logits.argmax(-1)[:, None].to(torch.int32)
    out = []
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        logits, cache = decode(params, cache, nxt)
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        out.append(nxt)
    _sync(dev)
    dt = time.perf_counter() - t0
    where = (f"{dev.type}: {torch.cuda.get_device_name(dev)}"
             if dev.type == "cuda" else dev.type)
    print(
        f"[lm:{cfg.name}] {args.tokens} tokens x {B} streams in {dt:.2f}s "
        f"= {args.tokens*B/dt:.1f} tok/s ({where}, reduced config)"
    )
    tokens = torch.cat(out, dim=1) if out else nxt[:, :0]
    return dict(cfg=cfg, tokens=tokens, logits=logits, seconds=dt,
                tok_s=args.tokens * B / dt)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--service", default="viterbi",
                    choices=["viterbi", "engine", "lm"])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--stream-len", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--ebn0", type=float, default=4.0)
    ap.add_argument(
        "--code", default="ccsds-k7",
        help="registry standard to serve (repro_torch.codes.list_codes()): "
        "e.g. wifi-11a-r34 (punctured) or lte-tbcc (tail-biting; forces "
        "--mode batch)",
    )
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument(
        "--mode", default="tiled",
        choices=["tiled", "chunked", "sharded", "batch", "time_parallel"],
        help="decode scenario; time_parallel is the log-depth "
        "single-stream latency path",
    )
    ap.add_argument(
        "--use-kernel", action="store_true",
        help="streaming modes (tiled, chunked, sharded) take the one-pass "
        "ACS+traceback kernel (K2); without it, the two-pass path (K1 "
        "and the traceback).  Kernels run on the card either way",
    )
    ap.add_argument("--chunk-len", type=int, default=4096)
    ap.add_argument("--decision-depth", type=int, default=None)
    ap.add_argument(
        "--slo", default="mixed",
        choices=["mixed", "latency", "throughput"],
        help="engine service: SLO class of the synthetic tenants "
        "(mixed = one latency + one throughput + one tail-biting tenant)",
    )
    ap.add_argument(
        "--max-wait-ms", type=float, default=10.0,
        help="engine service: throughput-class batch-assembly deadline "
        "(the latency class waits a quarter of this)",
    )
    ap.add_argument(
        "--chaos", default=None, metavar="SCHEDULE.json",
        help="engine service: run the replay under the fault-injection "
        "harness; the JSON file is a runtime.chaos.ChaosSchedule",
    )
    ap.add_argument(
        "--checkpoint-dir", default=None,
        help="engine service: periodically checkpoint the session table "
        "here; the drain writes a final checkpoint and prints the "
        "failover stats",
    )
    ap.add_argument(
        "--scrub-rate", type=float, default=0.0,
        help="engine service: sampled fraction of dispatches run through "
        "the online SDC scrubber; 0 disables it.  The drain prints the "
        "scrub and quarantine summary",
    )
    ap.add_argument(
        "--metrics-jsonl", default=None,
        help="engine service: record lifecycle spans and a final metrics "
        "snapshot to this JSONL file and print the Prometheus text dump "
        "on drain; view with python -m repro_torch.obs.top --jsonl PATH",
    )
    ap.add_argument(
        "--device", default=None,
        help="cpu, or the card (default)",
    )
    return ap


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` (None: ``sys.argv``) and run the service; returns
    its report (``serve_viterbi``, ``serve_engine``, ``serve_lm``)."""
    args = _parser().parse_args(argv)
    if args.service == "viterbi":
        return serve_viterbi(args)
    if args.service == "engine":
        return serve_engine(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
