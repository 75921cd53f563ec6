"""A/B timing of kernels B2 (getz_two), B3/B10 (getz_tile), B9 (the
forest's getz_two), B7 (getz_cg), B14 (the ring step) and the B4 stage
(lap) between checkouts of the port, on one CUDA card.

    python cup3d_tpu_torch/tools/kernel_ab.py [--only SECTIONS] [TREE ...]

``--only`` takes a comma-separated list of the sections below (getz_two,
getz for getz_tile/getz_amr/getz_cg, ring for ring_shift/all_to_all/
host_us, lap); default all.

Each TREE is the root of a checkout of the repository (default: this
one).  The trees run in the order given, each in a process of its own
(every checkout's package has the same name), so ``A B B A`` gives each
two samples, in turns, on one card and one host.  Each process builds
its tree's kernels and prints one JSON line (``"tree"`` and):

- ``getz_two``: B2 at T = 32,768 tiles (the 256^3 TGV) and T = 4,096
  (the 128^3 fish): CUDA-event time a call (median of 21 samples of 10
  calls), the device time a launch on ``torch.profiler``, and the first
  16 hex digits of the SHA-1 of its output (equal digests: equal bits);
- ``getz_tile``: B3 at T = 32,768 tiles and one h2, and B10 on the
  forest of BASELINE config #3 after init's adaptation (chip_smoke.py's
  ``AMR_ARGV``: 9,472 blocks) with its column of per-block h^2: event
  time and device time a launch, as above, and the library yardstick
  (TF32 off; B3: one ``torch.matmul`` of the (T, 512) rows by the dense
  512 x 512 tile operator; B10: one ``torch.einsum`` of the rows, the
  operator and the column of -h^2), on trees whose ``tilesolve`` has
  ``dense_operator``;
- ``getz_amr``: B9 on the same forest and h^2 column, with random w, azf
  and zc: event time, device time a launch (kernels named ``getz_amr``),
  the error against the plain version, whether a rerun is bitwise, and
  the library yardstick (one ``torch.einsum`` of the rows of w - azf,
  the tile operator and the column of -h^2; the product, not the + zc);
- ``getz_cg``: B7 at 256^3 in the lanes layout (8, 8, 8, 32768), 24
  sweeps, shift 0: event time, device time a launch, and whether a
  rerun is bitwise;
- ``ring_shift``: B14 on phase 15's Krylov exchange array (4 shards x
  449 entries x 1 component x 8^3 f32): event time a call, device time
  a launch, ``torch.roll`` on the shard axis;
- ``all_to_all``: one ``ring_all_to_all`` of the (4, 4, 449, 1, 8,8,8)
  send buffer beside ``compat.all_to_all`` (the axis swap): event times
  and the device kernels one exchange launches on the profile;
- ``host_us``: the host cost of the pieces of a ring-step call, each
  timed with ``time.perf_counter`` over 1,000 calls: the ctypes address
  tables built from Python generators, ``cuda_lib.load()``,
  ``torch.cuda.current_stream(dev).cuda_stream``, the raw stream
  lookup, the shape and overlap checks, ``torch.empty_like``, the whole
  ``ring_shift_kernel`` call, and ``torch.roll``; on a tree with the
  strided ring step also the call into a given ``out`` and the C entry
  point alone (the launch);
- ``lap``: the B4 stage on the periodic 128^3 and 256^3 grids (the fish's
  and the TGV's), f32 and bf16 storage, random w and a (one generator
  seeded 16 for the section, so both trees see the same bits): on a
  tree whose ``fused_bicgstab`` has ``LapGeom`` the kernel reading its
  faces from w, ``lap(w, a, inv_h2, geom)``; on an older tree the torch
  face-plane gather and the plane-fed kernel, ``lap(w, planes(w), a,
  inv_h2)`` with ``planes = krylov.make_tile_planes(grid)``.  Each: the
  CUDA-event time a call, the device time a call by profile (every
  device kernel of the stage summed), the device kernels a call, the
  host us a call (50 calls after a synchronise), whether Aw is bitwise
  the plain Laplacian rounded to the storage, and the first 16 hex
  digits of the SHA-1 of Aw; then ``iteration``: the device kernels of
  the fused solve (``fused_bicgstab_tiles`` at tolerance 0) over one
  chunk of ITER_CHUNK iterations and over two, on the periodic 128^3 grid
  and on BASELINE config #5's 128 x 64 x 64 with walls in y, and their
  difference over ITER_CHUNK: an iteration's kernels (with a share of
  the chunk's predicate read).

Prints the card's ``nvidia-smi`` name and power limit first.  ``python
cup3d_tpu_torch/tools/kernel_ab.py --child TREE [M]`` measures one tree
in this process (M entries an exchange) and prints its line alone
(chip_smoke.py phase 15 reads the exchange's profile from it: a fresh
process's profiler).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

D, MK = 4, 449           # phase 15's Krylov exchange: shards, entries
HOST_CALLS = 1000
SAMPLES, PER_SAMPLE = 21, 10
CG_ITERS = 24            # the CG getZ's sweeps (ops/krylov.py)
LAP_SIZES = (128, 256)   # B4's periodic grids: the fish's, the TGV's
# the fused iteration's grids: the periodic 128^3, config #5's walls in y
ITER_GRIDS = (((128,) * 3, ("periodic",) * 3),
              ((128, 64, 64), ("periodic", "wall", "periodic")))


def _events_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(SAMPLES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(PER_SAMPLE):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / PER_SAMPLE)
    return statistics.median(out)


def _device_events(torch, fn, calls: int, windows: int = 3) -> list:
    """The device records of ``calls`` calls of ``fn``, from the one of
    ``windows`` profiler windows that saw the most (a window can miss
    some of its kernels' records, never add any)."""
    # torch-lint: allow(JX012, the tool's own device read of one kernel,
    # run alone by hand, never beside a driver's obs window)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if best is None or len(dev) > len(best):
            best = dev
    return best


def _kernels(events) -> list:
    """The kernels among device records (copies and memsets left out)."""
    return [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]


def _profile(torch, fn, calls: int, match: str, windows: int = 3):
    """(device us a launch of the kernels whose name holds ``match``,
    launches of them a call, device kernels of any name a call), from the
    one of ``windows`` profiler windows that saw the most kernels."""
    best = _device_events(torch, fn, calls, windows)
    ours = [e for e in best if match in e.name]
    us = (sum(e.time_range.elapsed_us() for e in ours) / len(ours)
          if ours else None)
    return us, len(ours) / calls, len(best) / calls


def _host_us(fn, calls: int = HOST_CALLS) -> float:
    fn()
    # torch-lint: allow(JX008, an A/B timing harness run by hand over
    # checkouts, no driver metric) torch-lint: allow(JX020, the
    # harness's own interval clock; it imports the checkout under
    # test, not this tree's obs layer)
    # torch-lint: allow(JX006, the host's launch time on purpose: the
    # device's is _device_events)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    # torch-lint: allow(JX006, the host's launch time on purpose)
    return (time.perf_counter() - t0) / calls * 1e6


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _forest_h2(torch, tree: str, dev):
    """The per-block h^2 column of BASELINE config #3's forest after
    init's adaptation: ``build_driver`` of chip_smoke.py's ``AMR_ARGV``
    (the forest chip_smoke.py's phase 10 times B10 on)."""
    import chip_smoke
    from cup3d_tpu_torch.__main__ import build_driver

    out = os.path.join(os.path.abspath(tree), "runs", "kernel_ab")
    os.makedirs(out, exist_ok=True)
    d = build_driver(f"{chip_smoke.AMR_ARGV} -verbose 0 "
                     f"-path4serialization {out}".split())
    d.init()
    h = d.grid.h_column(torch.float32, dev).reshape(d.grid.nb)
    return (h * h).contiguous()


def iteration_kernels(torch, fb, grid, b) -> dict:
    """Device kernels of the fused solve of ``b`` (tile-major) on
    ``grid`` at tolerance 0: over one chunk of ITER_CHUNK iterations and
    over two (``torch.profiler``), and their difference over ITER_CHUNK,
    an iteration's kernels (the solve's set-up cancels; a chunk's
    predicate read is shared among its iterations)."""
    from cup3d_tpu_torch.ops import krylov

    chunk = krylov.ITER_CHUNK
    n = {}
    for m in (chunk, 2 * chunk):
        n[m] = len(_kernels(_device_events(
            torch, lambda: fb.fused_bicgstab_tiles(
                grid, b, tol_abs=0.0, tol_rel=0.0, maxiter=m), 1)))
    return dict(one_chunk=n[chunk], two_chunks=n[2 * chunk],
                per_iteration=(n[2 * chunk] - n[chunk]) / chunk)


def lap_section(torch, dev) -> dict:
    """The ``lap`` section (see the module docstring)."""
    from cup3d_tpu_torch.grid.uniform import UniformGrid
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.ops import krylov

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    out = {}
    for n in LAP_SIZES:
        grid = UniformGrid((n, n, n), (2 * math.pi,) * 3)
        T, inv_h2 = (n // 8) ** 3, 1.0 / (grid.h * grid.h)
        for store in (torch.float32, torch.bfloat16):
            w, a = (torch.randn((T, 8, 8, 8), generator=gen,
                                device=dev).to(store) for _ in range(2))
            if hasattr(fb, "LapGeom"):
                geom = fb.LapGeom(grid)
                stage = lambda: fb.lap(w, a, inv_h2, geom)  # noqa: E731
            else:
                planes = krylov.make_tile_planes(grid, 8)
                stage = lambda: fb.lap(w, planes(w), a,  # noqa: E731
                                       inv_h2)
            aw = stage()[0]
            plain = krylov.make_laplacian_tiles(grid, 8)(w.float())
            events = _device_events(torch, stage, 20)
            torch.cuda.synchronize()
            out[f"{n}_{str(store)[6:]}"] = dict(
                ms=_events_ms(torch, stage),
                device_us=sum(e.time_range.elapsed_us()
                              for e in events) / 20,
                kernels_a_call=len(_kernels(events)) / 20,
                host_us=_host_us(stage, 50),
                bitwise_plain=bool(torch.equal(aw, plain.to(store))),
                sha1=hashlib.sha1(aw.float().cpu().numpy().tobytes())
                .hexdigest()[:16])
            del w, a, aw, plain
    it = {}
    for shape, bcs in ITER_GRIDS:
        grid = UniformGrid(shape, tuple(2.0 * s / shape[0] for s in shape),
                           bcs)
        b = torch.randn((grid.ncells // 512, 8, 8, 8), generator=gen,
                        device=dev)
        it["x".join(map(str, shape)) + "_" + bcs[1]] = iteration_kernels(
            torch, fb, grid, b - b.mean())
    out["iteration"] = it
    return out


def child(tree: str, mk: int = MK, only=None) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from cup3d_tpu_torch.ops import cuda_lib
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    dev = torch.device("cuda")
    for line in cuda_lib.load().log.splitlines():  # ptxas: registers, spills
        if "Compiling" in line or "registers" in line or "spill" in line:
            print(f"[{tree}] {line.strip()}", file=sys.stderr)
    out = {"tree": tree}

    def want(section):
        return only is None or section in only

    if want("lap"):
        out["lap"] = lap_section(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if want("getz_two"):
        getz_two_section(torch, fb, dev, gen, out)
    if want("getz"):
        getz_sections(torch, tree, dev, gen, out)
    if want("ring"):
        ring_sections(torch, dev, gen, mk, out)
    torch.cuda.synchronize()
    return out


def getz_two_section(torch, fb, dev, gen, out) -> None:
    """getz_two (see the module docstring)."""
    out["getz_two"] = {}
    for T in (32768, 4096):
        w = torch.randn((T, 8, 8, 8), generator=gen, device=dev)
        aux = torch.randn((8, T), generator=gen, device=dev)
        aux[7] = 0.0
        want = fb.getz_two(w, aux, 1e-3, kernels=False)
        got = fb.getz_two(w, aux, 1e-3)
        err = _rel(got, want)
        digest = hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()[:16]
        us, n, _ = _profile(torch, lambda: fb.getz_two(w, aux, 1e-3), 20,
                            "getz_two")
        out["getz_two"][T] = dict(
            ms=_events_ms(torch, lambda: fb.getz_two(w, aux, 1e-3)),
            device_us=us, launches_a_call=n, rel_err=err, sha1=digest)
        del w, aux, want, got


def getz_sections(torch, tree, dev, gen, out) -> None:
    """getz_tile, getz_amr and getz_cg (see the module docstring)."""
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.ops import getz_cg, tilesolve

    torch.backends.cuda.matmul.allow_tf32 = False
    T, h2 = 32768, (2 * math.pi / 256) ** 2
    w = torch.randn((T, 8, 8, 8), generator=gen, device=dev)
    W = (tilesolve.dense_operator(8, torch.float32, str(dev))
         if hasattr(tilesolve, "dense_operator") else None)
    want = fb.getz_tile(w, h2, kernels=False)
    us, n, _ = _profile(torch, lambda: fb.getz_tile(w, h2), 20, "getz_tile")
    out["getz_tile"] = {T: dict(
        ms=_events_ms(torch, lambda: fb.getz_tile(w, h2)), device_us=us,
        launches_a_call=n, rel_err=_rel(fb.getz_tile(w, h2), want))}
    if W is not None:  # -h2 W built once, outside the timed call
        M = -h2 * W
        out["getz_tile"][T]["library_ms"] = _events_ms(
            torch, lambda: torch.matmul(w.view(T, 512), M))
    del w, want
    h2c = _forest_h2(torch, tree, dev)
    nf = h2c.numel()
    wf = torch.randn((nf, 8, 8, 8), generator=gen, device=dev)
    us, n, _ = _profile(torch, lambda: fa.getz_tile(wf, h2c), 20,
                        "getz_tile")
    out["getz_tile"][nf] = dict(
        ms=_events_ms(torch, lambda: fa.getz_tile(wf, h2c)), device_us=us,
        launches_a_call=n, rel_err=_rel(fa.getz_tile(wf, h2c),
                                        fa.getz_tile(wf, h2c, kernels=False)))
    if W is not None:
        neg_h2 = -h2c
        out["getz_tile"][nf]["library_ms"] = _events_ms(
            torch, lambda: torch.einsum("tc,cd,t->td", wf.view(nf, 512), W,
                                        neg_h2))
    azf = torch.randn((nf, 8, 8, 8), generator=gen, device=dev)
    zc = torch.randn(nf, generator=gen, device=dev)
    got = fa.getz_two(wf, azf, zc, h2c)
    us, n, _ = _profile(torch, lambda: fa.getz_two(wf, azf, zc, h2c), 20,
                        "getz_amr")
    out["getz_amr"] = {nf: dict(
        ms=_events_ms(torch, lambda: fa.getz_two(wf, azf, zc, h2c)),
        device_us=us, launches_a_call=n,
        rel_err=_rel(got, fa.getz_two(wf, azf, zc, h2c, kernels=False)),
        bitwise_rerun=bool(torch.equal(fa.getz_two(wf, azf, zc, h2c), got)))}
    if W is not None:
        rows, neg_h2 = (wf - azf).view(nf, 512), -h2c
        out["getz_amr"][nf]["library_ms"] = _events_ms(
            torch, lambda: torch.einsum("tc,cd,t->td", rows, W, neg_h2))
    del wf, azf, got
    bt = torch.randn((8, 8, 8, T), generator=gen, device=dev)
    got = getz_cg.cg_tiles_lanes(bt, CG_ITERS)
    us, n, _ = _profile(torch, lambda: getz_cg.cg_tiles_lanes(bt, CG_ITERS),
                        5, "getz_cg")
    out["getz_cg"] = {T: dict(
        ms=_events_ms(torch, lambda: getz_cg.cg_tiles_lanes(bt, CG_ITERS)),
        device_us=us, launches_a_call=n,
        rel_err=_rel(got, getz_cg.cg_tiles_lanes(bt, CG_ITERS,
                                                 kernels=False)),
        rerun_bitwise=bool(torch.equal(getz_cg.cg_tiles_lanes(bt, CG_ITERS),
                                       got)))}
    del bt, got


def ring_sections(torch, dev, gen, mk, out) -> None:
    """ring_shift, all_to_all and host_us (see the module docstring)."""
    from cup3d_tpu_torch.ops import cuda_lib
    from cup3d_tpu_torch.parallel import compat, ring

    x = torch.randn((D, mk, 1, 8, 8, 8), generator=gen, device=dev)
    if not torch.equal(ring.ring_shift_kernel(x, 1),
                       ring.ring_shift_plain(x, 1)):
        raise AssertionError("ring_shift_kernel != plain")
    us, _, _ = _profile(torch, lambda: ring.ring_shift_kernel(x, 1), 20,
                        "ring")
    out["ring_shift"] = dict(
        ms=_events_ms(torch, lambda: ring.ring_shift_kernel(x, 1)),
        device_us=us,
        roll_ms=_events_ms(torch, lambda: torch.roll(x, 1, 0)))
    send = torch.randn((D, D, mk, 1, 8, 8, 8), generator=gen, device=dev)
    if not torch.equal(ring.ring_all_to_all(send), compat.all_to_all(send)):
        raise AssertionError("ring_all_to_all != the swap")
    us, n, kernels = _profile(torch, lambda: ring.ring_all_to_all(send), 5,
                              "ring")
    out["all_to_all"] = dict(
        ms=_events_ms(torch, lambda: ring.ring_all_to_all(send)),
        swap_ms=_events_ms(torch, lambda: compat.all_to_all(send)),
        ring_launches=n, kernels=kernels, ring_device_us=us)

    # the pieces of a ring-step call on the host
    nbytes = x[0].numel() * x.element_size()
    lo, hi = x.data_ptr(), x.data_ptr() + D * nbytes

    def tables():
        src = (ctypes.c_uint64 * D)(*(lo + s * nbytes for s in range(D)))
        dst = (ctypes.c_uint64 * D)(*(hi + s * nbytes for s in range(D)))
        return src, dst

    def checks():
        if not x.is_cuda or not x.is_contiguous() or x.dim() < 1:
            raise ValueError
        n = x[0].numel() * x.element_size()
        a, b = x.data_ptr(), hi
        return a < b + D * n and b < a + D * n

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    out["host_us"] = dict(
        tables=_host_us(tables),
        load=_host_us(cuda_lib.load),
        current_stream=_host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        raw_stream=_host_us(
            lambda: torch._C._cuda_getCurrentRawStream(idx)),
        checks=_host_us(checks),
        empty_like=_host_us(lambda: torch.empty_like(x)),
        call=_host_us(lambda: ring.ring_shift_kernel(x, 1)),
        roll=_host_us(lambda: torch.roll(x, 1, 0)))
    if hasattr(ring, "ring_steps_kernel"):  # the strided ring step's pieces
        pre = torch.empty_like(x)
        ring.ring_steps_kernel(x, pre, 1)
        lay = next(iter(ring._LAYOUT.values()))[0]
        blk = ring._TLS.blk
        out["host_us"].update(
            call_into=_host_us(lambda: ring.ring_steps_kernel(x, pre, 1)),
            c_launch=_host_us(lambda: ring._STEPS(lay, blk)))


def main(argv) -> int:
    only = None
    if argv[:1] == ["--only"]:
        only, argv = argv[1].split(","), argv[2:]
    if len(argv) > 1 and argv[0] == "--child":  # [--child TREE [M]]
        mk = int(argv[2]) if len(argv) > 2 else MK
        print(json.dumps(child(argv[1], mk, only)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    pick = ["--only", ",".join(only)] if only else []
    for tree in argv or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), *pick,
                        "--child", tree], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
