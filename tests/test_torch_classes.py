"""The port's traffic classes (``arrow_matrix_tpu_torch.classes``)
against the JAX package's on the same inputs, and class-aware serving
on the CPU: an approx tenant under an explicit certificate (derived
from the JAX package's probed error curve of the same structure) is
priced at 2 bytes an element, served on the bf16 carriage within the
class tolerance of the f32 result, never batched with exact traffic;
without a covering certificate it is served exact, loudly; both
servers give the same census."""

import dataclasses

import numpy as np
import pytest
import torch

from arrow_matrix_tpu import classes as jcls
from arrow_matrix_tpu import serve as jserve
from arrow_matrix_tpu_torch import classes as pcls
from arrow_matrix_tpu_torch import serve as pserve

torch.set_num_threads(2)

N, WIDTH, K, SEED = 64, 16, 2, 5
CURVE_ITERS = 4


@pytest.fixture(scope="module")
def curves():
    """The JAX package's probed error curves of the structure (the
    certificate source)."""
    from arrow_matrix_tpu.ledger.probe import error_curves_for_source

    source = {"kind": "ba", "n": N, "m": 3, "width": WIDTH, "seed": SEED}
    return error_curves_for_source(source, k=K, iterations=CURVE_ITERS,
                                   seed=SEED,
                                   dtypes=("f32", "bf16", "int8"))


@pytest.fixture(scope="module")
def certs(curves):
    rec = next(r for r in curves if r["knobs"]["dtype"] == "bf16")
    return pcls.certificate_from_record(rec), \
        jcls.certificate_from_record(rec)


@pytest.fixture(scope="module")
def factories():
    return (pserve.ba_executor_factory(N, WIDTH, SEED, device="cpu"),
            jserve.ba_executor_factory(N, WIDTH, SEED, fmt="fold"))


def _trace(serve, requests=2, iterations=2, traffic_class="exact"):
    trace = serve.synthetic_trace(N, tenants=1, requests=requests, k=K,
                                  iterations=iterations, seed=SEED)
    return [dataclasses.replace(r, traffic_class=traffic_class)
            for r in trace]


def test_class_model_equals_jax():
    for name in ("exact", "approx"):
        for int8 in (False, True):
            assert vars(pcls.resolve_class(name, int8=int8)) == \
                vars(jcls.resolve_class(name, int8=int8))
    for dt in (None, "f32", "bf16", "int8"):
        assert pcls.class_itemsize(dt) == jcls.class_itemsize(dt)
        assert pcls.tolerance_for(dt) == jcls.tolerance_for(dt)
    for bad in (lambda m: m.resolve_class("fast"),
                lambda m: m.class_itemsize("fp8"),
                lambda m: m.tolerance_for("fp8")):
        with pytest.raises(ValueError):
            bad(pcls)
        with pytest.raises(ValueError):
            bad(jcls)
    assert pcls.TRAFFIC_CLASSES == jcls.TRAFFIC_CLASSES


def test_certificates_equal_jax(curves, certs):
    for rec in curves + [{"kind": "other"}, {"kind": "error_curve",
                                             "payload": {}}]:
        ours = pcls.certificate_from_record(rec)
        theirs = jcls.certificate_from_record(rec)
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert ours.to_dict() == theirs.to_dict()
            for it in range(0, CURVE_ITERS + 2):
                assert ours.bound_at(it) == theirs.bound_at(it)
                assert ours.covers(it) == theirs.covers(it)
    ours, theirs = certs
    assert pcls.Certificate.from_dict(theirs.to_dict()) == ours
    for dtype in ("bf16", "int8"):
        for emulated in (False, True):
            a = pcls.find_certificate(ours.structure_hash, dtype,
                                      records=curves,
                                      allow_emulated=emulated)
            b = jcls.find_certificate(ours.structure_hash, dtype,
                                      records=curves,
                                      allow_emulated=emulated)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.to_dict() == b.to_dict()
    assert [c.dtype for c in pcls.certified_classes(
        ours.structure_hash, records=curves)] == \
        [c.dtype for c in jcls.certified_classes(ours.structure_hash,
                                                 records=curves)]


def _store(curves, directory):
    """The curve records appended to a ledger store by the port."""
    from arrow_matrix_tpu_torch.ledger import Ledger

    lg = Ledger(directory)
    for rec in curves:
        lg.record(rec["kind"], rec["metric"], rec["value"],
                  unit=rec["unit"], structure_hash=rec["structure_hash"],
                  knobs=rec["knobs"], payload=rec["payload"],
                  platform=rec["platform"],
                  device_kind=rec["device_kind"], host_load=None,
                  git_rev=None)
    return directory


def test_ledger_lookup_equals_jax(curves, certs, tmp_path):
    store = _store(curves, str(tmp_path / "ledger"))
    shash = certs[0].structure_hash
    for dtype in ("bf16", "int8"):
        for emulated in (False, True):
            a = pcls.find_certificate(shash, dtype, ledger_dir=store,
                                      allow_emulated=emulated)
            b = jcls.find_certificate(shash, dtype, ledger_dir=store,
                                      allow_emulated=emulated)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.to_dict() == b.to_dict()
                assert a.record_id is not None
    assert pcls.find_certificate(shash, "bf16", ledger_dir=store
                                 ).rel_frobenius == certs[0].rel_frobenius
    assert [c.to_dict() for c in pcls.certified_classes(
        shash, ledger_dir=store)] == \
        [c.to_dict() for c in jcls.certified_classes(shash,
                                                     ledger_dir=store)]
    for d in (str(tmp_path / "absent"), store):
        assert pcls.find_certificate("no-such-hash", "bf16",
                                     ledger_dir=d) is None
        assert jcls.find_certificate("no-such-hash", "bf16",
                                     ledger_dir=d) is None


def test_server_finds_its_certificate_in_the_ledger(factories, curves,
                                                    certs, tmp_path):
    """``cert_ledger_dir`` with a structure hash: both servers load the
    same bf16 certificate from the same store and serve approx on it."""
    store = _store(curves, str(tmp_path / "ledger"))
    shash = certs[0].structure_hash
    (pfac, _), (jfac, _) = factories
    ours = pserve.ArrowServer(pfac, pserve.ExecConfig(),
                              structure_hash=shash, cert_ledger_dir=store)
    theirs = jserve.ArrowServer(jfac, jserve.ExecConfig(),
                                structure_hash=shash,
                                cert_ledger_dir=store)
    assert ours.summary()["certificates"] == \
        theirs.summary()["certificates"]
    assert set(ours.summary()["certificates"]) == {"bf16"}
    tickets = pserve.run_trace(ours, _trace(pserve,
                                            traffic_class="approx"))
    assert [t.served_class for t in tickets] == ["approx"] * 2
    # an empty store (or none given) loads nothing: approx falls back
    bare = pserve.ArrowServer(pfac, pserve.ExecConfig(),
                              structure_hash=shash,
                              cert_ledger_dir=str(tmp_path / "empty"))
    assert bare.summary()["certificates"] == {}


def test_approx_is_priced_at_two_bytes_and_served_bf16(factories, certs):
    fac, _ = factories[0]
    cert = certs[0]
    ex = fac(pserve.ExecConfig())
    ref = pserve.run_trace(pserve.ArrowServer(fac, pserve.ExecConfig()),
                           _trace(pserve))
    srv = pserve.ArrowServer(fac, pserve.ExecConfig(), certificates=[cert])
    tickets = pserve.run_trace(srv, _trace(pserve,
                                           traffic_class="approx"))
    assert pserve.request_price_bytes(ex, 64, itemsize=2) < \
        pserve.request_price_bytes(ex, 64)
    for t, r in zip(tickets, ref):
        assert t.status == "completed" and t.served_class == "approx"
        assert t.class_fallback is None
        # At k = 2 both carriages fit one 512-byte allocator block.
        assert t.predicted_bytes == pserve.request_price_bytes(
            ex, K, itemsize=2) <= r.predicted_bytes
        assert t.exec_config.feature_dtype == "bf16"
        assert t.certified_bound == cert.bound_at(2)
        d = t.result.astype(np.float64) - r.result.astype(np.float64)
        rel = float(np.linalg.norm(d)
                    / np.linalg.norm(r.result.astype(np.float64)))
        assert 0.0 < rel <= cert.tolerance


def test_mixed_classes_never_share_a_batch(factories, certs):
    fac, _ = factories[0]
    ref = pserve.run_trace(pserve.ArrowServer(fac, pserve.ExecConfig()),
                           _trace(pserve))
    srv = pserve.ArrowServer(fac, pserve.ExecConfig(),
                             certificates=[certs[0]], max_batch_k=2 * K)
    trace = (_trace(pserve, traffic_class="approx")
             + _trace(pserve, traffic_class="exact"))
    tickets = [srv.submit(r) for r in trace]
    srv.drain()
    assert srv.summary()["batched_requests"] == 4
    assert srv.summary()["batches"] == 2
    for t, r in zip(tickets[2:], ref):
        assert t.result.tobytes() == r.result.tobytes()
    for t, r in zip(tickets[:2], ref):
        assert t.served_class == "approx"
        assert t.result.tobytes() != r.result.tobytes()


def _class_census(serve, fac, certs, trace):
    srv = serve.ArrowServer(fac, serve.ExecConfig(), certificates=certs,
                            max_batch_k=2 * K)
    tickets = serve.run_trace(srv, trace)
    s = srv.summary()
    return ({k: s[k] for k in ("admitted", "completed", "rejected",
                               "class_fallback", "batches")},
            s["classes"],
            [(t.status, t.reason, t.served_class, t.class_fallback,
              t.certified_bound) for t in tickets])


@pytest.mark.parametrize("case", ["certified", "no_certificate",
                                  "too_deep", "unknown_class"])
def test_class_census_equals_the_jax_server(factories, certs, case):
    def trace(serve):
        if case == "unknown_class":
            return _trace(serve, traffic_class="turbo")
        iters = CURVE_ITERS + 1 if case == "too_deep" else 2
        return (_trace(serve, traffic_class="approx", iterations=iters)
                + _trace(serve, traffic_class="exact", iterations=iters))

    use = [] if case == "no_certificate" else None
    ours = _class_census(pserve, factories[0][0],
                         use if use is not None else [certs[0]],
                         trace(pserve))
    theirs = _class_census(jserve, factories[1][0],
                           use if use is not None else [certs[1]],
                           trace(jserve))
    assert ours == theirs
