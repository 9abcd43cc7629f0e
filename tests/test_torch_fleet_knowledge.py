"""The fleet's knowledge paths against the reference: the port
``WorkloadDB``'s tenant-scoped ``find_match``, ``nearest_config`` and
``consolidate`` over one shared tenant-tagged store, and ``TenantDBView``'s
local label namespace and cross-tenant warm start, decision for decision."""
import numpy as np
import pytest

from repro.core.characterize import characterize
from repro.core.knowledge import WorkloadDB as JDB
from repro.kermit.fleet import TenantDBView as JView
from repro_torch.core.knowledge import WorkloadDB as PDB
from repro_torch.kermit.fleet import TenantDBView as PView

TENANTS = 3


def _stream(seed, n=36):
    """(tenant, characterization) pairs: windows drawn around class centres
    the tenants share, interleaved as a lockstep fleet would insert them."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 1, (5, 16)).astype(np.float32)
    out = []
    for k in range(n):
        c = centres[rng.integers(len(centres))]
        scale = rng.choice([0.01, 0.05, 0.3])
        w = c + rng.normal(0, scale, (int(rng.integers(4, 40)), 16))
        out.append((k % TENANTS, characterize(w.astype(np.float32))))
    return out


def _drive_db(db, stream):
    out = []
    for t, c in stream:
        m = db.find_match(c, tenant=t)
        if m is None:
            out.append(("new", db.insert(c, tenant=t)))
        else:
            out.append(("match", m, db.observe(m, c)))
    return out


def _char(mean, F=8):
    v = np.full(F, mean, np.float32)
    one = np.ones(F, np.float32)
    return {"mean": v, "std": one, "min": v - 1, "max": v + 1,
            "p75": v, "p90": v, "n": 50}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [{}, {"merge_eps": 0.2},
                                {"drift_eps": 0.05, "drift_alpha": 0.3,
                                 "max_records": 6}])
def test_tenant_scoped_store_matches_reference(seed, kw):
    stream = _stream(seed)
    ref, port = JDB(None, **kw), PDB(None, device="cpu", **kw)
    assert _drive_db(port, stream) == _drive_db(ref, stream)
    assert [r.tenant for r in port.records.values()] == \
        [r.tenant for r in ref.records.values()]
    for t in range(TENANTS):
        assert port.consolidate(tenant=t) == ref.consolidate(tenant=t)
    assert port.consolidate() == ref.consolidate()
    assert port.drain_events() == ref.drain_events()
    assert port.labels() == ref.labels()
    for i, label in enumerate(ref.labels()[::2]):
        cfg = {"microbatches": i + 1}
        ref.set_config(label, cfg, optimal=True)
        port.set_config(label, cfg, optimal=True)
    for t, c in stream:
        for tenant in (None, t):
            assert port.nearest_config(c, tenant=tenant) == \
                ref.nearest_config(c, tenant=tenant)
        m = ref.find_match(c, tenant=t)
        assert port.find_match(c, tenant=t) == m
        if m is not None:
            assert port.nearest_config(c, exclude_label=m, tenant=t) == \
                ref.nearest_config(c, exclude_label=m, tenant=t)


def _drive_views(views, stream):
    out = []
    for t, c in stream:
        v = views[t]
        m = v.find_match(c)
        if m is None:
            out.append(("new", t, v.insert(c)))
        else:
            out.append(("match", t, m, v.observe(m, c)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_tenant_views_match_reference(seed):
    stream = _stream(seed)
    jdb, pdb = JDB(None, merge_eps=0.2), PDB(None, merge_eps=0.2,
                                            device="cpu")
    jv = [JView(jdb, t, max_records=64) for t in range(TENANTS)]
    pv = [PView(pdb, t, max_records=64) for t in range(TENANTS)]
    assert _drive_views(pv, stream) == _drive_views(jv, stream)
    for a, b in zip(pv, jv):
        assert a.labels() == b.labels()
        assert a._l2g == b._l2g and a._next_label == b._next_label
        assert a.consolidate() == b.consolidate()
        assert a.drain_events() == b.drain_events()
        assert sorted(a.pure_characterizations()) == \
            sorted(b.pure_characterizations())
        assert a.device == pdb.device
    # tenant 0 tunes its classes; the others warm-start from them
    for label in jv[0].labels():
        jv[0].set_config(label, {"microbatches": 4}, optimal=True)
        pv[0].set_config(label, {"microbatches": 4}, optimal=True)
        jv[0].record_trace(label, [({"microbatches": 4}, 1.0)])
        pv[0].record_trace(label, [({"microbatches": 4}, 1.0)])
        jv[0].set_sensitivity(label, {"microbatches": 1.0})
        pv[0].set_sensitivity(label, {"microbatches": 1.0})
        assert pv[0].last_set_config == jv[0].last_set_config
    donors = 0
    for t, c in stream:
        a, b = pv[t], jv[t]
        a.last_foreign_donor = b.last_foreign_donor = None
        got, want = a.nearest_config(c), b.nearest_config(c)
        assert got == want
        assert a.last_foreign_donor == b.last_foreign_donor
        if want is not None:
            donors += b.last_foreign_donor is not None
            assert a.get_trace(got[1]) == b.get_trace(want[1])
            assert a.get_sensitivity(got[1]) == b.get_sensitivity(want[1])
    assert donors > 0


def test_transfer_off_sees_only_its_own_records():
    for DB, View, kw in ((JDB, JView, {}), (PDB, PView, {"device": "cpu"})):
        db = DB(None, **kw)
        va = View(db, 0, max_records=64)
        vb = View(db, 1, max_records=64)
        a = va.insert(_char(1.0))
        va.set_config(a, {"microbatches": 4}, optimal=True)
        vb.insert(_char(1.1))
        res = vb.nearest_config(_char(1.05))
        assert res is not None and res[0] == {"microbatches": 4}
        assert vb.last_foreign_donor == va._l2g[a]
        iso = View(db, 2, max_records=64, transfer=False)
        iso.insert(_char(1.0))
        assert iso.nearest_config(_char(1.0)) is None
        # matching stays tenant-scoped: each tenant matches its own class
        for view in (va, vb, iso):
            m = view.find_match(_char(1.0))
            assert db.records[view._l2g[m]].tenant == view.tenant


def test_synthetic_pairs_translate_between_namespaces():
    got = []
    for DB, View, kw in ((JDB, JView, {}), (PDB, PView, {"device": "cpu"})):
        db = DB(None, **kw)
        other = View(db, 0, max_records=64)
        other.insert(_char(5.0))              # shifts tenant 1's globals
        v = View(db, 1, max_records=64)
        x, y = v.insert(_char(0.0)), v.insert(_char(3.0))
        s = v.insert(_char(1.5), is_synthetic=True, pair=(x, y))
        got.append((x, y, s, v.find_synthetic((x, y)),
                    v.find_synthetic((x, 7)), v._l2g,
                    db.records[v._l2g[s]].pair, v.resolve(s),
                    sorted(v.pure_characterizations())))
    assert got[0] == got[1]
