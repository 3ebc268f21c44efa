"""Online scoring server: serve a trained run directory over HTTP,
counterpart of ``sls_tpu/cli/serve.py``.

    python -m sls_tpu_torch.cli.serve --run_dir models/<tag> --port 8321 \
        [--int8] [--wire int16] [--batch 36] [--max_wait_ms 8]
    python -m sls_tpu_torch.cli.serve --from_export artifacts/<tag>

Then:

    curl -s -X POST --data-binary @utt.pcm16 \
        -H 'Content-Type: application/octet-stream' \
        http://127.0.0.1:8321/score
    curl -s http://127.0.0.1:8321/stats

A run directory of either package is served (``serve/scorer.py``), or an
artifact of ``cli/export`` (``serve/export.py``).  Scores follow the
offline score-file contract (``scores/writer.log_probs_to_scores``): a
served score equals the score file's for the same audio at the same
batch shape.  It runs on the card; ``SLS_TPU_PLATFORM=cpu`` asks for the
CPU.  ``--dp N`` serves one replica on each of ``cuda:0 .. N-1``, every
engine batch cut over them (``serve/scorer.py``); ``--batch`` (and each
bucket) must divide by N.  It exits 2 when N exceeds the visible cards,
and with ``--from_export``, as the reference does.  On the CPU it serves
N replicas there.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run_dir", help="trained run directory")
    src.add_argument("--from_export",
                     help="serve a cli/export deployment artifact instead "
                          "of a run dir; batch/wire/int8 come from its "
                          "manifest (the exported program cannot retrace)")
    p.add_argument("--checkpoint", default=None,
                   help="explicit checkpoint path (default: last > best)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--batch", type=int, default=36,
                   help="fixed device batch (36, the reference's serving batch)")
    p.add_argument("--max_wait_ms", type=float, default=8.0,
                   help="max time a non-full batch waits before dispatch")
    p.add_argument("--buckets", default=None,
                   help="comma-separated smaller batch shapes (e.g. "
                        "'9,18' under --batch 36): partial batches "
                        "dispatch on the smallest fitting shape, cutting "
                        "low-traffic latency; each shape warms up once "
                        "at startup (run-dir serving only)")
    p.add_argument("--wire", choices=("float32", "int16", "mulaw"),
                   default="float32",
                   help="host->device wire dtype (int16 halves the bytes, "
                        "lossless for 16-bit sources; mulaw quarters them, "
                        "LOSSY)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel serving over N devices (0 = single "
                        "device): every engine batch is cut over one model "
                        "replica a card; --batch must be divisible by N")
    int8 = p.add_mutually_exclusive_group()
    int8.add_argument("--int8", dest="int8", action="store_true",
                      default=None, help="force int8 serving GEMMs on")
    int8.add_argument("--no_int8", dest="int8", action="store_false",
                      help="force the exact bf16 path")
    return p


def dp_devices(n: int):
    """The devices of ``--dp n``: ``cuda:0 .. n-1``, or n times the CPU
    under ``SLS_TPU_PLATFORM=cpu``; an error line (a string) when n
    exceeds the visible cards."""
    import torch

    from sls_tpu_torch.cli.main import _device_type

    if _device_type() == "cpu":
        return [torch.device("cpu")] * n
    visible = torch.cuda.device_count()
    if n > visible:
        return (f"ERROR: --dp {n} needs {n} cards; {visible} visible "
                "(CUDA_VISIBLE_DEVICES)")
    return [torch.device("cuda", i) for i in range(n)]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    if args.from_export:
        if args.dp:
            print("ERROR: --dp needs a run dir (exported programs carry "
                  "their device; re-export on the target instead)")
            return 2
        if buckets:
            print("ERROR: --buckets needs a run dir (exported programs "
                  "are fixed at one batch shape and cannot retrace)")
            return 2
    from sls_tpu_torch.cli.main import platform_device
    from sls_tpu_torch.serve.engine import BatchingEngine
    from sls_tpu_torch.serve.server import make_server

    devices = None
    if args.dp:
        devices = dp_devices(args.dp)
        if isinstance(devices, str):
            print(devices)
            return 2
    device = platform_device()
    if args.from_export:
        from sls_tpu_torch.serve.export import build_scorer_from_export

        print(f"loading artifact {args.from_export} (warmup)...", flush=True)
        manifest, forward, cut = build_scorer_from_export(args.from_export)
        if manifest["device"] != device.type:
            print(f"ERROR: the artifact was exported for {manifest['device']}, "
                  f"this server runs on {device.type}")
            return 2
        family = manifest["family"]
        batch, wire = manifest["batch_size"], manifest["wire_dtype"]
    else:
        from sls_tpu_torch.serve.scorer import build_scorer

        print(f"loading {args.run_dir} (build + warmup)...", flush=True)
        cfg, forward, cut = build_scorer(
            args.run_dir, args.checkpoint, int8=args.int8,
            wire_dtype=args.wire, batch_size=args.batch,
            bucket_sizes=buckets, device=device, devices=devices,
        )
        family = cfg.model.sae.variant if cfg.model.use_sae else "sls"
        batch, wire = args.batch, args.wire
    engine = BatchingEngine(
        forward, batch, cut=cut,
        max_wait_ms=args.max_wait_ms, wire_dtype=wire,
        bucket_sizes=None if args.from_export else buckets,
    ).start()
    httpd = make_server(engine, args.host, args.port)
    print(
        f"serving {family} model on http://{args.host}:{httpd.server_address[1]} "
        f"(batch={batch}, wire={wire}, cut={cut}, "
        f"device={device if devices is None else [str(d) for d in devices]})",
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
