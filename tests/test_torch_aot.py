"""The port's compiled store and background compile service
(cup3d_tpu_torch/aot/) on the CPU, against the JAX package's
(cup3d_tpu/aot/) where both have the piece.

Held against the JAX package: the compile service's status sequence and
counter deltas for the same submissions, the speculative lane rungs, the
advance's abstract argument shapes for the same numpy lane payloads, the
``/health``, postmortem and CLI JSON keys, each store's rejection of the
other's record, and an ``amr_tgv`` fleet run on a warm store within the
fleet parity bounds of the JAX fleet's.

The port's own: store round trips (forest tables bitwise, the sharded
forest's exchange tables, kernel library bytes), a record written for
another environment's fingerprint, the seams' identity without a store,
every corruption rejected, ``verify`` and ``gc``, a warm boot that
builds no table (with a no-store control that does; every advance is
bound, store or not), the service's miss -> queue -> serve path for a
cold forest's tables with its ``compile_wait`` phase and pid-5 trace
spans while the tgv jobs dispatch at once, the helper process kept
across drains, and the ``compile.service_die`` drill under a hard time
bound."""

import json
import os
import pickle
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cup3d_tpu.aot import compiler as jcompiler
from cup3d_tpu.aot import store as jstore
from cup3d_tpu.fleet import batch as JFB
from cup3d_tpu.fleet.server import FleetServer as JFleetServer
from cup3d_tpu.obs import metrics as JM
from cup3d_tpu_torch.aot import compiler as tcompiler
from cup3d_tpu_torch.aot import store as tstore
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.fleet import batch as TFB
from cup3d_tpu_torch.fleet.server import DONE, FleetServer, _lane_payload
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.obs import trace as OT
from cup3d_tpu_torch.ops import cuda_lib
from cup3d_tpu_torch.parallel import forest as PF
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.sim.amr import AMRSimulation, _leaves

TGV = dict(kind="tgv", n=16, nsteps=8, cfl=0.3)
AMR = dict(kind="amr_tgv", bpd=2, levelMax=2, nsteps=8, cfl=0.3)
#: the fleet parity bounds (tests/test_torch_fleet_amr.py)
KE_RTOL = 1e-4
VEL_ATOL = 1e-4
TIME_RTOL = 1e-4
ITERS_SLACK = 1
#: no test may wait longer than this on a serve loop
SERVE_BOUND_S = 120.0


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("CUP3D_AOT_STORE", raising=False)
    faults.clear()
    yield
    faults.clear()
    torch.set_num_threads(n)


def _delta(before, key, reg=M):
    return reg.snapshot().get(key, 0) - before.get(key, 0)


def _drain(tmp, specs, **kw):
    srv = FleetServer(workdir=str(tmp), device="cpu", **kw)
    ids = [srv.submit(f"t{i}", dict(sp)) for i, sp in enumerate(specs)]
    srv.drain()
    if srv._aot_service is not None:
        srv._aot_service.close()  # the helper process, if one started
    assert all(srv._jobs[j].status == DONE for j in ids)
    return srv, ids


def _amr_driver(tmp):
    cfg = SimulationConfig(
        bpdx=2, bpdy=2, bpdz=2, levelMax=2, levelStart=1, extent=2 * np.pi,
        nu=0.02, initCond="taylorGreen", tend=0.0, nsteps=2,
        verbose=False, freqDiagnostics=0, path4serialization=str(tmp))
    return AMRSimulation(cfg, device="cpu")


# -- held against the JAX package --------------------------------------------


def _service_trace(svc_cls, reg):
    """The same submissions through one package's CompileService: the
    status after each step and the counter deltas."""
    before = reg.snapshot()
    svc = svc_cls()
    seq = [svc.submit("k1", lambda: "built-1", name="one"),
           svc.submit("k1", lambda: "NEVER", name="dup")]
    assert svc.drain(timeout=30)
    seq += [svc.status("k1"), svc.take("k1"), svc.take("k1"),
            svc.status("k1"), svc.depth()]
    seq.append(svc.submit("k2", lambda: 1 / 0, name="boom"))
    assert svc.drain(timeout=30)
    seq.append(svc.status("k2"))
    seq.append(svc.submit("k2", lambda: "retry-ok", name="boom"))
    seq.append(svc.submit("k3", lambda: "spec", name="s",
                          priority=10))
    assert svc.drain(timeout=30)
    seq += [svc.take("k2"), svc.status("k3"), sorted(svc.state())]
    keys = ("aot.compile_submits{kind=demand}",
            "aot.compile_submits{kind=speculative}",
            "aot.background_compiles",
            "aot.compile_failures{executable=boom}",
            "aot.background_compile_s{executable=one}.count",
            "aot.background_compile_s{executable=boom}.count")
    return seq, {k: _delta(before, k, reg) for k in keys}


def test_compile_service_matches_jax():
    jseq, jd = _service_trace(jcompiler.CompileService, JM)
    tseq, td = _service_trace(tcompiler.CompileService, M)
    assert tseq == jseq
    assert td == jd
    assert (tcompiler.PRIORITY_DEMAND, tcompiler.PRIORITY_SPECULATIVE) == (
        jcompiler.PRIORITY_DEMAND, jcompiler.PRIORITY_SPECULATIVE)


@pytest.mark.parametrize("max_lanes", [None, 256])
def test_neighbor_rungs_match_jax(tmp_path, max_lanes):
    js = JFleetServer(workdir=str(tmp_path / "j"), max_lanes=max_lanes,
                      journal=False)
    ts = FleetServer(workdir=str(tmp_path / "t"), max_lanes=max_lanes,
                     journal=False, device="cpu")
    for cap in range(1, 257):
        assert ts._neighbor_rungs(cap) == js._neighbor_rungs(cap), cap
        assert ts.lane_capacity(cap) == js.lane_capacity(cap), cap


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@pytest.mark.parametrize("spec", [
    TGV, AMR, dict(kind="fish", n=16, nsteps=8, cfl=0.3, L=0.4)],
    ids=["tgv", "amr_tgv", "fish"])
def test_abstract_advance_args_match_jax(tmp_path, spec):
    srv = FleetServer(workdir=str(tmp_path), device="cpu", journal=False)
    jid = srv.submit("t", dict(spec))
    kind, drv, _, _ = srv._prepare(srv._jobs[jid])
    carry, gait = _lane_payload(kind, drv, jid)
    carry = {k: _np(v) for k, v in carry.items()}
    gait = None if gait is None else {k: _np(v) for k, v in gait.items()}
    for B, K in ((3, 8), (9, 4)):
        tc, tcfl, tg = TFB.abstract_advance_args(carry, gait, B, K,
                                                 np.float32)
        jc, jcfl, jg = JFB.abstract_advance_args(carry, gait, B, K,
                                                 np.float32)

        def same(t, j):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(j.shape)
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)

        assert sorted(tc) == sorted(jc)
        for k in jc:
            same(tc[k], jc[k])
        same(tcfl, jcfl)
        assert (tg is None) == (jg is None) == (gait is None)
        if gait is not None:
            assert sorted(tg) == sorted(jg)
            for k in jg:
                same(tg[k], jg[k])


def _jax_store_with_entry(root):
    import jax
    import jax.numpy as jnp

    st = jstore.ExecutableStore(str(root))
    w = jstore.StoreBackedExecutable(jax.jit(lambda x: jnp.sin(x) * 2.0),
                                     ("keys", 1), name="keys", store=st)
    w(jnp.ones(8, jnp.float32))
    assert st.contains(("keys", 1))
    return st


def _key_tree(obj, depth=3):
    if isinstance(obj, list):
        return [_key_tree(obj[0], depth)] if obj else []
    if not isinstance(obj, dict) or depth == 0:
        return None
    return {k: _key_tree(v, depth - 1) for k, v in obj.items()}


def test_health_flight_and_cli_keys_match_jax(tmp_path, monkeypatch,
                                              capsys):
    from cup3d_tpu.aot import cli as jcli
    from cup3d_tpu.obs import export as JX
    from cup3d_tpu.obs import flight as JFL
    from cup3d_tpu_torch.aot import cli as tcli
    from cup3d_tpu_torch.obs import export as TX
    from cup3d_tpu_torch.obs import flight as TFL

    _jax_store_with_entry(tmp_path / "j")
    tst = tstore.ExecutableStore(str(tmp_path / "t"))
    tst.put(("keys", 1), {"x": np.arange(4)}, name="keys")
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "j"))
    jh = JX.health_payload()["aot"]
    jblock = JFL._aot_block()
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "t"))
    th = TX.health_payload()["aot"]
    tblock = TFL._aot_block()
    assert _key_tree(th) == _key_tree(jh)
    assert th["store"]["files"] == jh["store"]["files"] == 1
    assert _key_tree(tblock, 1) == _key_tree(jblock, 1)
    assert tblock["active"] is jblock["active"] is True
    # a server's health block (store + service state)
    srv = FleetServer(workdir=str(tmp_path / "s"), device="cpu")
    srv._aot()
    jsrv = JFleetServer(workdir=str(tmp_path / "js"))
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "j"))
    jsrv._aot()
    assert _key_tree(srv._aot_health()) == _key_tree(jsrv._aot_health())

    outs = {}
    for cmd in (["list"], ["verify"], ["gc", "--max-bytes", "1"]):
        for tag, mod, root in (("j", jcli, "j"), ("t", tcli, "t")):
            args = cmd[:1] + ["--store", str(tmp_path / root)] + cmd[1:]
            rc = mod.main(args)
            outs[(cmd[0], tag)] = (rc, json.loads(capsys.readouterr().out))
    for cmd in ("list", "verify", "gc"):
        (jrc, jo), (trc, to) = outs[(cmd, "j")], outs[(cmd, "t")]
        assert jrc == trc == 0
        assert _key_tree(to) == _key_tree(jo), cmd
    assert outs[("gc", "t")][1]["gc"]["evicted"] == 1


def test_each_store_rejects_the_others_record(tmp_path):
    js = _jax_store_with_entry(tmp_path / "j")
    ts = tstore.ExecutableStore(str(tmp_path / "t"))
    sig = ("keys", 1)
    ts.put(("port", 1), {"x": np.arange(3)}, name="port")
    # hand-copied files: the JAX record where the port looks, and back
    jfile, tfile = js.path_for(sig), ts.path_for(("port", 1))
    Path(ts.path_for(sig)).write_bytes(Path(jfile).read_bytes())
    Path(js.path_for(("port", 1))).write_bytes(Path(tfile).read_bytes())
    jb, tb = JM.snapshot(), M.snapshot()
    assert ts.get(sig) is None
    assert _delta(tb, "aot.store_rejects{reason=fingerprint}") == 1
    assert not os.path.exists(ts.path_for(sig))
    assert js.get(("port", 1)) is None
    assert _delta(jb, "aot.store_rejects{reason=fingerprint}", JM) == 1
    assert not os.path.exists(js.path_for(("port", 1)))
    assert tstore.fingerprint()["framework"] == "torch"
    assert tstore.fingerprint_digest() != jstore.fingerprint_digest()


# -- the port's own ----------------------------------------------------------


def test_tables_round_trip_bitwise(tmp_path, monkeypatch):
    """A forest topology's tables through the store: every leaf of the
    loaded BucketGeo torch.equal (dtype, shape, bits) to a live build,
    and a driver on the warm store builds no table."""
    d = _amr_driver(tmp_path / "a")
    cap, geo = d._bucket_tables()
    st = tstore.ExecutableStore(str(tmp_path / "store"))
    from cup3d_tpu_torch.sim.amr import tables_payload

    st.put(("tables", 1), tables_payload(cap, geo), name="forest.tables")
    got = st.get(("tables", 1), name="forest.tables", device="cpu")
    assert got["cap"] == cap
    live, loaded = list(_leaves(geo)), list(_leaves(got["geo"]))
    assert len(live) == len(loaded)
    for a, b in zip(live, loaded):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    assert tstore.tensors_equal(geo, got["geo"])
    # the padding contract survives: h = 1 and volume 0 on padding
    nb = d.grid.nb
    assert np.all(got["geo"].geom.h[nb:] == 1.0)
    assert torch.all(got["geo"].vol[nb:] == 0)
    assert got["geo"].vol.dtype == torch.float32
    assert got["geo"].tab1.src.dtype == geo.tab1.src.dtype

    # the driver's seam: cold builds and puts, warm loads and builds none
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "seam"))
    cold = _amr_driver(tmp_path / "b")
    before = M.snapshot()
    warm = _amr_driver(tmp_path / "c")
    assert _delta(before, "bucket.table_builds") == 0
    assert _delta(before, "bucket.table_store_hits") == 1
    assert cold.table_build_s and not warm.table_build_s
    assert tstore.tensors_equal(cold._geo, warm._geo)


def test_sharded_exchange_round_trip(tmp_path, monkeypatch):
    """The sharded forest's exchange tables through the store: a fresh
    ShardedForest loads them and assembles labs and flux corrections
    bitwise the live build's."""
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "store"))
    g = _amr_driver(tmp_path / "a").grid
    mesh = PF.make_block_mesh([torch.device("cpu")] * 4)
    PF._FOREST_MEMO.clear()
    live = PF.cached_forest(g, mesh, store_sig=("t", 1))
    PF._FOREST_MEMO.clear()
    before = M.snapshot()
    loaded = PF.cached_forest(g, mesh, store_sig=("t", 1))
    PF._FOREST_MEMO.clear()
    assert _delta(before, "forest.table_store_hits") == 1
    assert _delta(before, "forest.table_builds") == 0
    gen = torch.Generator().manual_seed(3)
    w = torch.randn((live.nb_pad, 8, 8, 8), generator=gen) * live.pmask
    for width in (1, 3):
        a = live.face_tables(width).assemble_scalar(w, 8)
        b = loaded.face_tables(width).assemble_scalar(w, 8)
        assert torch.equal(a, b)
    fl = torch.randn((live.nb_pad, 6, 8, 8), generator=gen)
    out = torch.randn((live.nb_pad, 8, 8, 8), generator=gen)
    assert torch.equal(live.flux_tables.apply(out.clone(), fl),
                       loaded.flux_tables.apply(out.clone(), fl))
    assert loaded.flux_tables.forest is loaded


def test_kernel_records_round_trip_and_fall_back(tmp_path):
    """``kernels`` records with synthetic library bytes (no nvcc here):
    the bytes come back equal in a digest-named file under the store's
    own directory; a corrupt record is a miss (the caller runs nvcc from
    the repo's source), counted and removed."""
    st = tstore.ExecutableStore(str(tmp_path / "store"))
    src = tmp_path / "k.cu"
    src.write_text("// a kernel source\n")
    lib = tmp_path / "libk.so"
    lib.write_bytes(os.urandom(4096))
    assert cuda_lib.store_load(st, src, "nvcc 1") is None  # a miss
    cuda_lib.store_put(st, src, "nvcc 1", lib)
    path = cuda_lib.store_load(st, src, "nvcc 1")
    assert path.read_bytes() == lib.read_bytes()
    assert path.parent == Path(st.root) / tstore.LIB_DIR
    assert tstore.sig_digest(cuda_lib.kernel_sig(src, "nvcc 1")) in path.name
    # the key moves with the source, the flags' compiler and its version
    assert cuda_lib.store_load(st, src, "nvcc 2") is None
    src.write_text("// another text\n")
    assert cuda_lib.store_load(st, src, "nvcc 1") is None
    src.write_text("// a kernel source\n")
    # a flipped byte: rejected, removed with its unpacked library
    rec = st.path_for(cuda_lib.kernel_sig(src, "nvcc 1"))
    blob = bytearray(Path(rec).read_bytes())
    blob[-10] ^= 0xFF
    Path(rec).write_bytes(bytes(blob))
    before = M.snapshot()
    assert cuda_lib.store_load(st, src, "nvcc 1") is None
    assert _delta(before, "aot.store_rejects{reason=checksum}") == 1
    assert not os.path.exists(rec) and not path.exists()


def test_seams_are_identity_without_a_store(tmp_path):
    assert tstore.active_store() is None
    srv = FleetServer(workdir=str(tmp_path / "s"), device="cpu")
    assert srv._aot() == (None, None) and srv._aot_health() is None
    before = M.snapshot()
    s2, _ = _drain(tmp_path / "e", [dict(TGV, nsteps=1),
                                    dict(AMR, nsteps=1)])
    assert s2._aot_service is None and s2._aot_health() is None
    assert _delta(before, "aot.store_misses") == 0
    assert _delta(before, "aot.compile_submits{kind=demand}") == 0
    d = _amr_driver(tmp_path / "a")
    assert d.table_build_s  # built live, nothing looked up
    g = d.grid
    PF._FOREST_MEMO.clear()
    fo = PF.cached_forest(g, PF.make_block_mesh([torch.device("cpu")] * 2),
                          store_sig=("t", 1))
    PF._FOREST_MEMO.clear()
    assert fo._lab_cache == {} and fo._flux_cache is None


def test_sig_collision_rejected(tmp_path):
    st = tstore.ExecutableStore(str(tmp_path))
    st.put(("a", 1), {"x": 1}, name="a")
    Path(st.path_for(("b", 2))).write_bytes(
        Path(st.path_for(("a", 1))).read_bytes())
    before = M.snapshot()
    assert st.get(("b", 2)) is None
    assert _delta(before, "aot.store_rejects{reason=sig-collision}") == 1
    assert not st.contains(("b", 2)) and st.get(("a", 1)) == {"x": 1}


def _rewrite(path, mutate):
    blob = Path(path).read_bytes()
    Path(path).write_bytes(mutate(blob))


def _schema2(blob):
    body = blob[len(tstore.MAGIC):]
    rec = pickle.loads(body[body.find(b"\n") + 1:])
    rec["schema"] = 2
    import hashlib

    inner = pickle.dumps(rec, protocol=4)
    return (tstore.MAGIC + hashlib.blake2s(inner).hexdigest().encode()
            + b"\n" + inner)


@pytest.mark.parametrize("damage,reason", [
    (lambda b: b[: len(b) // 2], "checksum"),
    (lambda b: b[:-20] + bytes(x ^ 0xFF for x in b[-20:]), "checksum"),
    (lambda b: b"NOTAOT\n" + b[len(tstore.MAGIC):], "magic"),
    (_schema2, "schema"),
    (lambda b: b[: len(tstore.MAGIC)] + b"0" * 64 + b[len(tstore.MAGIC)
                                                      + 64:], "checksum"),
    (lambda b: b[: len(tstore.MAGIC) + 10], "truncated"),
], ids=["truncate", "flip", "magic", "schema", "checksum", "no-newline"])
def test_corrupt_record_rejected(tmp_path, damage, reason):
    """Every defect is a miss: counted by reason, the file removed, the
    caller builds live (here: the tables of a driver on that store)."""
    st = tstore.ExecutableStore(str(tmp_path / "s"))
    payload = {"cap": 3, "geo": tstore.to_host(
        (torch.arange(5, dtype=torch.int64), torch.ones(2)))}
    st.put(("c", 1), payload, name="c")
    _rewrite(st.path_for(("c", 1)), damage)
    before = M.snapshot()
    assert st.get(("c", 1), device="cpu") is None
    assert _delta(before, f"aot.store_rejects{{reason={reason}}}") == 1
    assert not st.contains(("c", 1))


def test_store_corrupt_fault_falls_back_to_a_live_build(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "store"))
    cold = _amr_driver(tmp_path / "a")
    faults.arm("aot.store_corrupt", "*", 1)
    before = M.snapshot()
    again = _amr_driver(tmp_path / "b")
    assert _delta(before, "faults.injected{site=aot.store_corrupt}") == 1
    assert _delta(before, "aot.store_rejects{reason=checksum}") == 1
    assert _delta(before, "bucket.table_builds") == 1
    assert tstore.tensors_equal(cold._geo, again._geo)


def test_verify_and_gc_under_bound(tmp_path):
    st = tstore.ExecutableStore(str(tmp_path))
    sigs = [("gc", i) for i in range(3)]
    for i, sig in enumerate(sigs):
        st.put(sig, {"x": np.full(256, i)}, name=f"gc-{i}")
        os.utime(st.path_for(sig), (i + 1.0, i + 1.0))
    bad = ("gc", "bad")
    st.put(bad, {"x": 1}, name="bad")
    _rewrite(st.path_for(bad), lambda b: b[:-4])
    rep = st.verify()
    assert rep == {"ok": 3, "rejected": 1, "reasons": {"checksum": 1}}
    one = os.path.getsize(st.path_for(sigs[0]))
    before = M.snapshot()
    st.max_bytes = 2 * one + one // 2
    res = st.gc()
    assert st.total_bytes() <= st.max_bytes and res["evicted"] == 1
    assert _delta(before, "aot.store_gc_evictions") == 1
    assert not st.contains(sigs[0]) and st.contains(sigs[2])
    assert st.get(sigs[2])["x"][0] == 2


def test_warm_boot_builds_nothing(tmp_path, monkeypatch):
    """A second server on the warm store serves tgv and amr_tgv jobs with
    zero table builds, rows bitwise the first server's; the no-store
    control builds (the assertion bites).  Every server binds its
    advances (a bind builds nothing the store could hold), as many as
    the cold one.  The warm server's amr_tgv lane within the fleet
    parity bounds (tests/test_torch_fleet_amr.py) of the JAX package's
    fleet (which runs without a store)."""
    specs = [TGV, AMR]
    monkeypatch.setenv("CUP3D_FUSED", "1")
    jsrv = JFleetServer(workdir=str(tmp_path / "jax"))
    jid = jsrv.submit("t1", dict(AMR))
    jsrv.drain()
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "store"))
    before = M.snapshot()
    s1, i1 = _drain(tmp_path / "w1", specs)
    binds = _delta(before, "fleet.executable_builds")
    assert binds >= 2 and _delta(before, "bucket.table_builds") >= 1
    assert tstore.active_store().state()["files"] >= 1
    before = M.snapshot()
    s2, i2 = _drain(tmp_path / "w2", specs)
    assert _delta(before, "fleet.executable_builds") == binds
    assert _delta(before, "bucket.table_builds") == 0
    assert _delta(before, "aot.store_hits") >= 1
    assert all(s2._jobs[b].qoi_bytes() == s1._jobs[a].qoi_bytes()
               for a, b in zip(i1, i2))
    assert s2.health()["aot"]["store"]["files"] >= 1
    assert s2.health()["aot"]["service"]["tasks"] == {}  # nothing cold
    jl = {k: np.asarray(v) for k, v in jsrv.lane_state(jid).items()}
    tl = {k: np.asarray(v) for k, v in s2.lane_state(i2[1]).items()}
    ke_t = float(np.sum(tl["vel"].astype(np.float64) ** 2))
    ke_j = float(np.sum(jl["vel"].astype(np.float64) ** 2))
    assert abs(ke_t - ke_j) <= KE_RTOL * ke_j
    np.testing.assert_allclose(tl["vel"], jl["vel"], rtol=0, atol=VEL_ATOL)
    jr, tr = jsrv._jobs[jid].rows, s2._jobs[i2[1]].rows
    assert np.all(np.abs(jr[:, 1] - tr[:, 1]) <= ITERS_SLACK)
    np.testing.assert_allclose(tr[:, -3:], jr[:, -3:], rtol=TIME_RTOL)
    monkeypatch.delenv("CUP3D_AOT_STORE")
    before = M.snapshot()
    s3, i3 = _drain(tmp_path / "w3", specs)
    assert _delta(before, "fleet.executable_builds") >= 2
    assert _delta(before, "bucket.table_builds") >= 1
    assert all(s3._jobs[b].qoi_bytes() == s1._jobs[a].qoi_bytes()
               for a, b in zip(i1, i3))


def test_miss_queue_serve_with_compile_wait(tmp_path, monkeypatch):
    """A cold amr_tgv forest's tables build off the dispatch thread (miss
    -> queue -> serve): its job sits in a nonzero compile_wait phase, the
    build leaves a pid-5 span flow-linked to the job's lane span, and the
    tgv jobs, which need no build, dispatch without waiting; a warm boot
    never opens the phase."""
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "store"))
    td = str(tmp_path / "trace")
    OT.TRACE.configure(enabled=True, directory=td)
    before = M.snapshot()
    try:
        s1, ids = _drain(tmp_path / "w1", [TGV, dict(TGV, cfl=0.25), AMR])
        OT.TRACE.flush()
        OT.TRACE.export_chrome()
    finally:
        OT.TRACE.close()
        OT.TRACE.configure(enabled=False)
    assert _delta(before, "aot.compile_submits{kind=demand}") == 1
    assert _delta(before, "aot.background_compiles") == 1
    assert _delta(before, "aot.store_writes") >= 1
    cold = {j: s1._jobs[j].phases().get("compile_wait", 0.0) for j in ids}
    assert cold[ids[2]] > 0, cold
    for j in ids[:2]:
        assert s1._jobs[j].event_time("compile_wait") is None, j
    assert s1._jobs[ids[2]].event_time("compile_ready") is not None
    for j in ids:
        times = [t for _, t in s1._jobs[j].events]
        assert sum(s1._jobs[j].phases().values()) == pytest.approx(
            times[-1] - times[0], rel=1e-9, abs=1e-12)
    with open(os.path.join(td, "trace.pfto.json")) as f:
        events = json.load(f)["traceEvents"]
    track = [e for e in events if e.get("pid") == OT.COMPILE_PID]
    assert any(e["ph"] == "M" and e["name"] == "process_name"
               for e in track)
    spans = [e for e in track if e["ph"] == "X"]
    assert spans and all(e["args"]["outcome"] == "done" for e in spans)
    assert any(e["name"] == "forest.tables" for e in spans)
    starts = {e["id"] for e in events
              if e.get("ph") == "s" and e.get("cat") == "flow"}
    finishes = {e["id"] for e in events
                if e.get("ph") == "f" and e.get("cat") == "flow"}
    assert starts == {ids[2]} and finishes == starts

    s2, ids2 = _drain(tmp_path / "w2", [TGV, dict(TGV, cfl=0.25), AMR])
    for j in ids2:
        assert s2._jobs[j].event_time("compile_wait") is None


def test_helper_process_outlives_a_drain(tmp_path, monkeypatch):
    """The service's helper process starts at the first cold table build
    and serves the next drain's build too (its start costs seconds);
    ``close`` stops it."""
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "store"))
    srv = FleetServer(workdir=str(tmp_path / "w"), device="cpu")
    j1 = srv.submit("t0", dict(AMR, nsteps=1))
    srv.drain()
    host = srv._aot_service.host
    proc = host._proc
    assert proc is not None and proc.poll() is None
    before = M.snapshot()
    j2 = srv.submit("t1", dict(AMR, bpd=3, nsteps=1))  # a cold forest
    srv.drain()
    assert all(srv._jobs[j].status == DONE for j in (j1, j2))
    assert _delta(before, "aot.background_compiles") == 1
    assert host._proc is proc and proc.poll() is None
    srv._aot_service.close()
    assert proc.poll() is not None and host._proc is None


def test_put_for_another_environment(tmp_path):
    """A record put with another environment's fingerprint lands under
    that environment's key: this process misses it, a reader of that
    fingerprint finds it, and its record carries it."""
    st = tstore.ExecutableStore(str(tmp_path / "st"))
    other = dict(tstore.fingerprint(), platform="cuda",
                 device_names=["NVIDIA H100 80GB HBM3"], device_count=1)
    sig = ("forest", "tables", "other-env")
    path = st.put(sig, {"x": np.arange(4)}, name="t", fp=other)
    assert path == st.path_for(sig, other) != st.path_for(sig)
    before = M.snapshot()
    assert st.get(sig) is None and os.path.exists(path)
    assert _delta(before, "aot.store_misses") == 1
    with open(path, "rb") as f:
        rec = pickle.loads(f.read().split(b"\n", 2)[2])
    assert rec["fingerprint"] == other
    mine = st.put(sig, {"x": np.arange(4)}, name="t")
    assert mine == st.path_for(sig) and st.get(sig)["x"].tolist() == [
        0, 1, 2, 3]


def test_service_death_falls_back_inline_under_a_bound(tmp_path,
                                                       monkeypatch):
    """The worker dies holding a RUNNING build: the serve loop reaps the
    orphan and binds inline, and every job ends done.  The serve runs in
    a thread joined with a timeout: the test fails, it never hangs."""
    monkeypatch.setenv("CUP3D_AOT_STORE", str(tmp_path / "store"))
    srv = FleetServer(workdir=str(tmp_path / "w"), device="cpu")
    ids = [srv.submit(f"t{i}", dict(sp))
           for i, sp in enumerate([TGV, dict(TGV, cfl=0.25), AMR])]
    faults.arm("compile.service_die", "*", 1)
    before = M.snapshot()
    box = {}

    def serve():
        try:
            box["summary"] = srv.drain()
        except BaseException as e:  # surfaced below
            box["error"] = e

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    th.join(SERVE_BOUND_S)
    assert not th.is_alive(), "serve() did not finish within its bound"
    srv._aot_service.close()
    assert "error" not in box, box.get("error")
    assert all(srv._jobs[j].status == DONE for j in ids)
    assert _delta(before, "faults.injected{site=compile.service_die}") == 1
    assert _delta(before, "aot.service_fallbacks") >= 1


def test_stale_build_is_failed_not_waited_for():
    """A build that hangs in a live worker is failed at its deadline, so
    nothing parked on it waits without bound."""
    svc = tcompiler.CompileService()
    gate = threading.Event()
    svc.submit("hang", lambda: gate.wait(30), name="hang")
    before = M.snapshot()
    assert svc.wait(0.05) is False
    assert svc.fail_stale(max_age=0.0) == 1
    assert svc.status("hang") == "failed" and svc.depth() == 0
    assert _delta(before, "aot.service_fallbacks") == 1
    gate.set()
    assert svc.drain(timeout=10)
    assert svc.status("hang") == "failed" and svc.take("hang") is None
