"""Export a trained run directory as a self-contained deployment artifact,
counterpart of ``sls_tpu/cli/export.py``.

    python -m sls_tpu_torch.cli.export models/<tag> --out artifacts/<tag> \
        [--batch 36] [--wire int16] [--int8] [--verify]

The artifact (a ``torch.export`` program with its weights, and a
manifest; ``serve/export.py``) reloads on a host that has ``torch`` and
this package's kernel library but not its model code, and plugs into
the serving engine:

    python -m sls_tpu_torch.cli.serve --from_export artifacts/<tag>

It is exported on, and for, the device this runs on: the card, or the
CPU under ``SLS_TPU_PLATFORM=cpu`` (the reference's ``--platforms`` has
no counterpart; the manifest names the device).  ``--verify`` reloads
the artifact and holds it to the live scorer (``load_serving_model``) on
one seeded batch: a log-prob drift above 1e-3 exits 1.
"""

from __future__ import annotations

import argparse
import json

VERIFY_TOL = 1e-3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("run_dir", help="trained run directory")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--checkpoint", default=None,
                   help="explicit checkpoint path (default: last > best)")
    p.add_argument("--batch", type=int, default=36,
                   help="fixed serving batch baked into the program "
                        "(36, the reference's serving batch)")
    p.add_argument("--wire", choices=("float32", "int16", "mulaw"),
                   default="float32",
                   help="on-wire audio dtype baked into the program")
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and diff vs the live scorer")
    int8 = p.add_mutually_exclusive_group()
    int8.add_argument("--int8", dest="int8", action="store_true",
                      default=None, help="force int8 serving GEMMs on")
    int8.add_argument("--no_int8", dest="int8", action="store_false",
                      help="force the exact bf16 path")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from sls_tpu_torch.cli.main import platform_device
    from sls_tpu_torch.serve.export import export_serving

    device = platform_device()
    manifest = export_serving(
        args.run_dir, args.out, batch_size=args.batch, wire_dtype=args.wire,
        int8=args.int8, checkpoint=args.checkpoint, device=device,
    )
    print(json.dumps({k: v for k, v in manifest.items() if k != "config"}, indent=1))

    if args.verify:
        import numpy as np

        from sls_tpu_torch.data.pipeline import to_wire
        from sls_tpu_torch.serve.export import load_exported
        from sls_tpu_torch.serve.scorer import load_serving_model

        manifest, exported_fwd = load_exported(args.out)
        _, live_fwd = load_serving_model(args.run_dir, args.checkpoint, int8=args.int8,
                                         device=device)
        rng = np.random.default_rng(0)
        wav = rng.normal(0, 0.1, size=(manifest["batch_size"], manifest["cut"])
                         ).astype(np.float32)
        wire = to_wire(wav, manifest["wire_dtype"])
        got = exported_fwd(wire).double().cpu()
        want = live_fwd(wire).double().cpu()
        diff = float((got - want).abs().max())
        print(json.dumps({"verify_max_abs_diff": diff}))
        if diff > VERIFY_TOL:
            print("ERROR: exported program drifts from the live scorer")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
