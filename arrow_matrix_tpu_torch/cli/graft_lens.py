"""``graft_lens``: the operator surface of the lens's cost model.

The port's copy of ``arrow_matrix_tpu/cli/graft_lens.py``, run as
``python -m arrow_matrix_tpu_torch.cli.graft_lens``.  ``profile`` runs
on the card unless ``--device cpu``.  ``--kernel pallas`` profiles K1
with its launch knobs (``MultiLevelArrow(kernel="pallas_sell")``), and
``--ring-sweep`` adds K1's load-depth sweep under it: each tier alone
at batch 4 against the profile's batch, the analogue of the reference's
``ring=1`` (``obs/lens.py``).  ``predict --ring 1`` prices the shallow
point.  Subcommands close the profile → fit → predict loop:

* ``profile`` — per-degree-ladder-level chained timing of one
  structure's fold step (``obs/lens.py:profile_fold``) per carriage
  dtype, each measurement paired with its static counters; writes the
  profile document (``--out``) and optionally sinks ``kind="lens"``
  ledger records (``--ledger-dir``).
* ``fit`` — fit the per-level-family model
  ``t ≈ α·nnz + β·rows + γ·streamed_bytes`` from a profile document
  and write it as a versioned CostModel JSON.
* ``predict`` — predict one candidate's iteration ms from a model and
  a structure source, WITHOUT running anything (the tune compute
  screen's primitive).
* ``explain`` — attribute the bf16-vs-f32 (or any dtype pair)
  full-iteration gap per level and name the dominant segment
  (gather-bytes / decode-accumulate / dma-wait).
* ``check`` — validate a profile (+model): schema, attribution
  coverage, calibration ratios in band; exits nonzero on problems
  (the engine of ``arrow_matrix_tpu_torch/tools/lens_gate.py``).

Prints ONE JSON line as its last stdout line (CLI contract).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _add_source_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ba", type=str, default=None,
                   help="Barabasi-Albert source: N,WIDTH,SEED")
    p.add_argument("--ba_m", type=int, default=3,
                   help="BA attachment parameter m")
    p.add_argument("--max_levels", type=int, default=10)
    p.add_argument("--base", type=str, default=None,
                   help="io/graphio artifact base path (e.g. the "
                        "output of arrow_decompose)")
    p.add_argument("--width", type=int, default=None,
                   help="decomposition width inside --base (default: "
                        "autodetect)")


def _source_from_args(args) -> dict:
    if args.ba and args.base:
        raise SystemExit("graft_lens: --ba and --base are exclusive")
    if args.ba:
        try:
            n, width, seed = (int(v) for v in args.ba.split(","))
        except ValueError:
            raise SystemExit("graft_lens: --ba wants N,WIDTH,SEED "
                             "(e.g. --ba 256,32,0)")
        return {"kind": "ba", "n": n, "m": args.ba_m, "width": width,
                "seed": seed, "max_levels": args.max_levels}
    if args.base:
        src = {"kind": "dir", "base": args.base}
        if args.width:
            src["width"] = args.width
        return src
    raise SystemExit("graft_lens: need --ba N,WIDTH,SEED or "
                     "--base DIR")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graft_lens", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("profile", help="per-level chained timing of "
                                        "one structure's fold step")
    _add_source_args(pr)
    pr.add_argument("--k", type=int, default=64,
                    help="feature width to profile (default 64 — "
                         "enough per-tier work that prefix "
                         "differencing resolves the small tiers)")
    pr.add_argument("--kernel", choices=("auto", "xla", "pallas"),
                    default="auto")
    pr.add_argument("--dtypes", type=str, default="f32,bf16",
                    help="comma-separated carriage dtypes "
                         "(default f32,bf16 — the pair separates the "
                         "byte coefficient)")
    pr.add_argument("--iters", type=int, default=100,
                    help="chained iterations per measurement")
    pr.add_argument("--ring-sweep", action="store_true",
                    help="re-time each tier at batch=4 (pallas only): "
                         "the excess is the load wait a deeper batch "
                         "hides (the reference's ring=1 sweep)")
    pr.add_argument("--out", type=str, default=None,
                    help="write the profile document here")
    pr.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")
    pr.add_argument("--ledger-dir", type=str, default=None,
                    help="sink kind='lens' records (ms + coverage; "
                         "with --fit also the calibration ratios)")
    pr.add_argument("--fit", type=str, default=None, metavar="MODEL",
                    help="also fit and write the CostModel JSON here")

    f = sub.add_parser("fit", help="fit the per-level-family cost "
                                   "model from a profile")
    f.add_argument("profile", help="profile JSON (graft_lens profile "
                                   "--out)")
    f.add_argument("--out", type=str, default=None,
                   help="write the CostModel JSON here")
    f.add_argument("--dtypes", type=str, default=None,
                   help="restrict the fit to these carriage dtypes")

    pd = sub.add_parser("predict", help="predict iteration ms for a "
                                        "structure from a model — no "
                                        "execution")
    pd.add_argument("model", help="CostModel JSON (graft_lens fit "
                                  "--out)")
    _add_source_args(pd)
    pd.add_argument("--k", type=int, default=64)
    pd.add_argument("--kernel", choices=("xla", "pallas"),
                    default="xla")
    pd.add_argument("--dtype", type=str, default="f32",
                    help="carriage dtype (f32 / bf16)")
    pd.add_argument("--ring", type=int, default=None,
                    help="1 prices K1 at the shallow load depth "
                         "(batch=4): adds the per-level wait the deep "
                         "batch hides")

    e = sub.add_parser("explain", help="attribute a dtype pair's "
                                       "full-iteration gap per level")
    e.add_argument("profile")
    e.add_argument("--model", type=str, default=None,
                   help="CostModel JSON: classifies the dominant "
                        "delta into gather-bytes vs decode/accumulate")
    e.add_argument("--base", dest="base_dtype", type=str,
                   default="f32")
    e.add_argument("--other", dest="other_dtype", type=str,
                   default="bf16")

    c = sub.add_parser("check", help="validate a profile (+model); "
                                     "nonzero on problems")
    c.add_argument("profile")
    c.add_argument("--model", type=str, default=None)
    c.add_argument("--coverage-tol", type=float, default=None,
                   help="override LENS_COVERAGE_TOL")
    return p


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _load_model(path: str):
    from arrow_matrix_tpu_torch.obs.costmodel import CostModel
    return CostModel.from_dict(_load_json(path))


def _levels(args):
    from arrow_matrix_tpu_torch.tune.search import load_levels_from_source
    return load_levels_from_source(_source_from_args(args))


def cmd_profile(args) -> int:
    from arrow_matrix_tpu_torch.obs import lens

    levels, width = _levels(args)
    dtypes = tuple(d for d in args.dtypes.split(",") if d)
    profile = lens.profile_fold(
        levels, width, args.k, kernel=args.kernel,
        feature_dtypes=dtypes, iters=args.iters,
        ring_sweep=args.ring_sweep, device=args.device)
    model = None
    if args.fit:
        model = lens.fit_from_profile(profile)
        from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json
        atomic_write_json(args.fit, model.to_dict(), indent=2,
                          sort_keys=True)
    if args.out:
        from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json
        atomic_write_json(args.out, profile, indent=2, sort_keys=True)
    record_ids: List[str] = []
    if args.ledger_dir:
        record_ids = lens.record_profile(profile, model,
                                         directory=args.ledger_dir)
    summary = {
        "ok": True, "cmd": "profile",
        "structure_hash": profile["structure_hash"],
        "kernel": profile["kernel"], "k": profile["k"],
        "dtypes": {fd: {"full_ms": round(entry["full_ms"], 6),
                        "coverage": round(entry["coverage"], 4)}
                   for fd, entry in profile["dtypes"].items()},
        "records": len(record_ids),
    }
    if "sweep" in profile:
        summary["sweep"] = profile["sweep"]
    if args.out:
        summary["profile"] = args.out
    if args.fit:
        summary["model"] = args.fit
    print(json.dumps(summary, sort_keys=True))
    return 0


def cmd_fit(args) -> int:
    from arrow_matrix_tpu_torch.obs import lens

    profile = _load_json(args.profile)
    dtypes = (tuple(d for d in args.dtypes.split(",") if d)
              if args.dtypes else None)
    model = lens.fit_from_profile(profile, dtypes=dtypes)
    if args.out:
        from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json
        atomic_write_json(args.out, model.to_dict(), indent=2,
                          sort_keys=True)
    print(json.dumps({"ok": True, "cmd": "fit",
                      "structure_hash": model.structure_hash,
                      "families": sorted(model.coeffs),
                      **({"model": args.out} if args.out else {})},
                     sort_keys=True))
    return 0


def cmd_predict(args) -> int:
    import numpy as np

    from arrow_matrix_tpu_torch.obs.costmodel import predict_iter_ms
    from arrow_matrix_tpu_torch.tune.fingerprint import structure_fingerprint

    model = _load_model(args.model)
    levels, width = _levels(args)
    fp = structure_fingerprint(levels, width, np.float32)
    fd = None if args.dtype == "f32" else args.dtype
    ms = predict_iter_ms(fp, args.k, model, kernel=args.kernel,
                         feature_dtype=fd, ring=args.ring)
    print(json.dumps({"ok": True, "cmd": "predict",
                      "predicted_ms": round(float(ms), 6),
                      "kernel": args.kernel, "k": args.k,
                      "dtype": args.dtype}, sort_keys=True))
    return 0


def cmd_explain(args) -> int:
    from arrow_matrix_tpu_torch.obs import lens

    profile = _load_json(args.profile)
    model = _load_model(args.model) if args.model else None
    gap = lens.explain_gap(profile, base=args.base_dtype,
                           other=args.other_dtype, model=model)
    if gap.get("note"):
        print(gap["note"])
    print(json.dumps({"ok": True, "cmd": "explain",
                      "gap_ms": round(gap["gap_ms"], 6),
                      "dominant": gap["dominant"],
                      "dominant_segment": gap["dominant_segment"],
                      "per_level": {lbl: round(v, 6) for lbl, v
                                    in gap["per_level"].items()}},
                     sort_keys=True))
    return 0


def cmd_check(args) -> int:
    from arrow_matrix_tpu_torch.obs import lens

    profile = _load_json(args.profile)
    model = _load_model(args.model) if args.model else None
    kwargs = {}
    if args.coverage_tol is not None:
        kwargs["coverage_tol"] = args.coverage_tol
    problems = lens.check_profile(profile, model, **kwargs)
    for p in problems:
        print(f"lens check: {p}", file=sys.stderr)
    print(json.dumps({"ok": not problems, "cmd": "check",
                      "problems": problems}, sort_keys=True))
    return 1 if problems else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"profile": cmd_profile, "fit": cmd_fit,
            "predict": cmd_predict, "explain": cmd_explain,
            "check": cmd_check}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
