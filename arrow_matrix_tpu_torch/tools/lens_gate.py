"""Lens gate: validate a lens calibration (profile and cost model).

The port's copy of ``tools/lens_gate.py``.  The default mode validates
documents and runs no kernel: it reads the JAX package's committed
BA 256/3 profile and model pairs in ``bench_results/lens/`` (read only;
host records, never the port's calibration) and re-runs the port's
``obs/lens.py:check_profile`` on them: schema drift, per-tier
attribution failing to cover the measured iteration (|1 - cov| >
0.10), a measured/predicted ratio outside [0.5, 2.0], or a profile and
model that disagree on the structure hash fail.  The port's own pair
is written by ``--refresh`` into ``bench_results/lens_torch/``
(gitignored) and checked with ``--profile``/``--model``.

    python -m arrow_matrix_tpu_torch.tools.lens_gate
        check the committed pairs
    python -m arrow_matrix_tpu_torch.tools.lens_gate --refresh [--device cpu]
        profile BA 256/3 (k=64, f32 + bf16) with the port's lens on the
        card, write the pair to bench_results/lens_torch/, append
        kind='lens' records to the port's ledger and rebaseline it
    python -m arrow_matrix_tpu_torch.tools.lens_gate --fixture F
        check a fixture ({"profile": .., "model": ..}) as real data: a
        planted miscalibration exits nonzero
    python -m arrow_matrix_tpu_torch.tools.lens_gate --fixtures
        every fixture in tests/fixtures/lens/ must trip the check
    python -m arrow_matrix_tpu_torch.tools.lens_gate --selftest
        a synthetic profile and model: clean passes, perturbed trips
"""

import argparse
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LENS_DIR = os.path.join(REPO, "bench_results", "lens")
PROFILE_PATH = os.path.join(LENS_DIR, "ba_256_3_profile.json")
MODEL_PATH = os.path.join(LENS_DIR, "ba_256_3_model.json")
#: The same structure under the reference's synthesized per-tier
#: schedule, fitted on its scheduled family keys (``pallas:fam@rbN``).
SYNTH_PROFILE_PATH = os.path.join(LENS_DIR,
                                  "ba_256_3_synth_profile.json")
SYNTH_MODEL_PATH = os.path.join(LENS_DIR, "ba_256_3_synth_model.json")
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "lens")
#: Where ``--refresh`` writes the port's own pair (gitignored).
TORCH_LENS_DIR = os.path.join(REPO, "bench_results", "lens_torch")

#: The calibration point: the BA 256/3 seed-0 width-32 decomposition.
BA_256_3_SOURCE = {"kind": "ba", "n": 256, "m": 3, "width": 32,
                   "seed": 0, "max_levels": 10}
REFRESH_K = 64
REFRESH_ATTEMPTS = 3


def _load(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def check_pair(profile: dict, model_doc: dict) -> list:
    """Problems of one profile and model: the lens check, plus the two
    documents' agreement on the structure hash."""
    from arrow_matrix_tpu_torch.obs import lens
    from arrow_matrix_tpu_torch.obs.costmodel import CostModel

    try:
        model = CostModel.from_dict(model_doc)
    except (ValueError, KeyError, TypeError) as e:
        return [f"cost model unreadable: {e}"]
    problems = lens.check_profile(profile, model)
    ph = str(profile.get("structure_hash", ""))
    if ph and model.structure_hash and ph != model.structure_hash:
        problems.append(
            f"structure hash mismatch: profile {ph} vs model "
            f"{model.structure_hash}")
    return problems


def run_fixture(path: str) -> int:
    doc = _load(path)
    problems = check_pair(doc["profile"], doc["model"])
    for p in problems:
        print(f"lens gate: {os.path.basename(path)}: {p}",
              file=sys.stderr)
    return 1 if problems else 0


def run_fixtures() -> int:
    paths = sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.json")))
    if not paths:
        print("lens gate: no fixtures found", file=sys.stderr)
        return 1
    rc = 0
    for path in paths:
        if run_fixture(path) == 0:
            print(f"lens gate: FIXTURE {os.path.basename(path)} "
                  f"PASSED CLEAN — the lens check lost a detection",
                  file=sys.stderr)
            rc = 1
    if rc == 0:
        print(f"lens gate: {len(paths)} fixture(s) trip the check",
              file=sys.stderr)
    return rc


def selftest() -> int:
    """Host-only round trip: a self-consistent synthetic profile fits
    and checks clean; one tier's time x5 trips the ratio band; half the
    tier sum trips coverage."""
    import copy

    from arrow_matrix_tpu_torch.obs import lens

    tiers = [
        {"tier": 0, "family": "xla:tail", "rows": 200, "nnz": 900,
         "slots": 1600, "slot_width": 8, "padded_slots": 700,
         "streamed_bytes": 409600, "measured_ms": 0.06},
        {"tier": 1, "family": "xla:mid", "rows": 100, "nnz": 1200,
         "slots": 1600, "slot_width": 16, "padded_slots": 400,
         "streamed_bytes": 409600, "measured_ms": 0.04},
    ]
    profile = {
        "schema": lens.LENS_PROFILE_SCHEMA, "kind": "lens_profile",
        "structure_hash": "selftest", "platform": "cpu",
        "device_kind": "cpu", "width": 32, "k": 64, "kernel": "xla",
        "iters": 100, "kernel_opts": {}, "n": 300,
        "dtypes": {"f32": {
            "full_ms": 0.1, "chain_floor_ms": 0.001,
            "resolution_ms": 0.005, "attributed_ms": 0.1,
            "coverage": 1.0, "tiers": tiers, "dma_wait_ms": {}}},
    }
    model = lens.fit_from_profile(profile)
    clean = lens.check_profile(profile, model)
    if clean:
        print(f"lens gate selftest: clean profile reported problems: "
              f"{clean}", file=sys.stderr)
        return 1
    bad_ratio = copy.deepcopy(profile)
    bad_ratio["dtypes"]["f32"]["tiers"][0]["measured_ms"] *= 5.0
    if not any("ratio" in p
               for p in lens.check_profile(bad_ratio, model)):
        print("lens gate selftest: 5x tier did not trip the ratio "
              "band", file=sys.stderr)
        return 1
    bad_cov = copy.deepcopy(profile)
    bad_cov["dtypes"]["f32"]["attributed_ms"] = 0.05
    bad_cov["dtypes"]["f32"]["coverage"] = 0.5
    if not any("cover" in p for p in lens.check_profile(bad_cov)):
        print("lens gate selftest: half coverage did not trip",
              file=sys.stderr)
        return 1
    print("lens gate: selftest ok", file=sys.stderr)
    return 0


def refresh(ledger_dir=None, device=None, out_dir=TORCH_LENS_DIR) -> int:
    """Profile the calibration point with the port's lens, and write
    the pair, the ledger records and the ledger's baseline.  Retries a
    few times and writes only a profile that passes its own check."""
    from arrow_matrix_tpu_torch.ledger.gate import main as ledger_main
    from arrow_matrix_tpu_torch.obs import lens
    from arrow_matrix_tpu_torch.tune.search import load_levels_from_source
    from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

    levels, width = load_levels_from_source(BA_256_3_SOURCE)
    profile = model = problems = None
    for attempt in range(REFRESH_ATTEMPTS):
        profile = lens.profile_fold(levels, width, REFRESH_K,
                                    feature_dtypes=("f32", "bf16"),
                                    iters=100, device=device)
        model = lens.fit_from_profile(profile)
        problems = lens.check_profile(profile, model)
        if not problems:
            break
        print(f"lens gate: refresh attempt {attempt + 1} unclean: "
              f"{problems}", file=sys.stderr)
    if problems:
        print("lens gate: refresh could not produce a clean profile",
              file=sys.stderr)
        return 1
    ppath = os.path.join(out_dir, "ba_256_3_profile.json")
    mpath = os.path.join(out_dir, "ba_256_3_model.json")
    atomic_write_json(ppath, profile, indent=2, sort_keys=True)
    atomic_write_json(mpath, model.to_dict(), indent=2, sort_keys=True)
    ids = lens.record_profile(profile, model, directory=ledger_dir)
    rc = ledger_main(["--rebaseline"]
                     + (["--ledger-dir", ledger_dir] if ledger_dir else []))
    if rc != 0:
        print("lens gate: ledger rebaseline failed", file=sys.stderr)
        return rc
    print(f"lens gate: refreshed {ppath} and its model, {len(ids)} "
          f"ledger record(s)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refresh", action="store_true",
                    help="profile ba_256_3 with the port's lens and write "
                         "bench_results/lens_torch/, the ledger records "
                         "and its baseline")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="with --refresh: cuda (default: the card) or cpu")
    ap.add_argument("--ledger-dir", default=None,
                    help="with --refresh: the store (default: the "
                         "port's, AMT_LEDGER_DIR or "
                         "bench_results/ledger_torch)")
    ap.add_argument("--fixture", action="append", default=[],
                    help="check this profile+model fixture as real data "
                         "(a planted miscalibration exits nonzero; "
                         "repeatable)")
    ap.add_argument("--fixtures", action="store_true",
                    help="verify every shipped lens fixture trips the "
                         "check")
    ap.add_argument("--selftest", action="store_true",
                    help="synthetic round trip, no kernel run")
    ap.add_argument("--profile", default=PROFILE_PATH,
                    help="profile JSON to check (default: committed)")
    ap.add_argument("--model", default=MODEL_PATH,
                    help="model JSON to check (default: committed)")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest()
    if args.fixtures:
        return run_fixtures()
    if args.fixture:
        rc = 0
        for path in args.fixture:
            rc |= run_fixture(path)
        return rc
    if args.refresh:
        return refresh(ledger_dir=args.ledger_dir, device=args.device)

    pairs = [(args.profile, args.model, False)]
    if args.profile == PROFILE_PATH and args.model == MODEL_PATH:
        # The committed calibration is two pairs: the menu point and
        # the scheduled point.
        pairs.append((SYNTH_PROFILE_PATH, SYNTH_MODEL_PATH, True))
    problems = []
    for ppath, mpath, is_synth in pairs:
        missing = [p for p in (ppath, mpath) if not os.path.isfile(p)]
        if missing:
            for path in missing:
                print(f"lens gate: missing artifact {path}",
                      file=sys.stderr)
            return 1
        model_doc = _load(mpath)
        problems += check_pair(_load(ppath), model_doc)
        if is_synth and not any(
                "@rb" in f for f in (model_doc.get("coeffs") or {})):
            problems.append(
                f"{os.path.basename(mpath)}: no scheduled width-family "
                f"keys (kernel:fam@rbN)")
    if problems:
        for p in problems:
            print(f"lens gate: {p}", file=sys.stderr)
        print("lens gate: FAILED", file=sys.stderr)
        return 1
    print("lens gate: ok", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
