#!/usr/bin/env python3
"""K3 on the grouped kernel against the route it replaced, on one GPU.

    python3 tools/compare_k3_routes.py --parent DIR

``DIR`` is a checkout of commit eed88fb, the last before K3
(``qr_embedding_bag``) became the dense pooled case of
``csrc/grouped_lookup.cu`` (for example ``git archive eed88fb`` unpacked
under ``build/``, which git ignores).  Its ``csrc/embedding_bag.cu`` (the
old K3) and ``csrc/grouped_lookup.cu`` are built beside this tree's
kernels and called through their C interfaces as they stood at that
commit, so the script runs against that commit only.  It

1. holds this tree's grouped K4, K5 and K1 at full width (26 Kaggle QR
   pairs, D=16) against the parent's grouped kernel bit for bit: every
   launch is repeated by the parent's kernel into a second output;
2. times K3 at ``chip_smoke.py``'s shapes with ``chip_smoke.time_bag``
   (``ops.qr_bag_lookup``, its bound, plain version, yardstick, host µs
   and device operations per call, threads per bag), and beside it on the
   same inputs the replaced route (``idx % m``, ``idx // m``, the casts
   and the old kernel's launch, as the parent's ``ops.qr_bag_lookup`` ran
   them) and the old kernel alone on pre-split int32 ids; both must give
   the same bits as the new route; the host µs per call of the new and
   the replaced route are timed in turns;
3. builds two copies of this tree's ``grouped_lookup.cu`` with one
   constant changed (``kSlots = 8`` bag slots in flight, and
   ``kMaxTables = 1``: a one-table kernel parameter of 200 bytes instead of
   3,320) and times each in turns with the port's build (variant, port,
   port, variant; the same bits required): 8 slots at 8, 16 and 32 threads
   per bag at the bandwidth and bench shapes, the one-table parameter at
   K3's bench shape and K1's per-table bench shape (m=2048, q=16, D=128,
   N=512, int32 and int64 ids).

It prints the card's name and power limit and, last, one JSON object with
every number.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)

HOST_ROUNDS = 8   # turns of each route's host timing, per case
# this tree's grouped_lookup.cu with one constant changed: (name, line, replacement)
VARIANTS = (("slots8", "constexpr int kSlots = 4;", "constexpr int kSlots = 8;"),
            ("one_table", "constexpr int kMaxTables = 40;", "constexpr int kMaxTables = 1;"))


def _nvcc(src, target):
    from repro_torch.kernels import _build

    return subprocess.Popen([_build._nvcc(), *_build._FLAGS, "-o", str(target), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(name, proc, target):
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        smoke._fail(f"{name} does not build:\n{out}")
    smoke._print_registers(name, out)
    return ctypes.CDLL(str(target))


class Builds:
    """The parent's two sources and this tree's two variants, all compiled
    together with the port's own build."""

    def __init__(self, parent):
        from repro_torch.kernels import _build

        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        csrc = os.path.join(parent, "src", "repro_torch", "csrc")
        self._procs = {}
        for name in ("embedding_bag", "grouped_lookup"):
            target = _build.BUILD_DIR / f"libparent_{name}.{os.getpid()}.so"
            self._procs[f"parent {name}"] = (_nvcc(os.path.join(csrc, f"{name}.cu"), target),
                                             target)
        src = (_build._CSRC / "grouped_lookup.cu").read_text()
        for name, line, repl in VARIANTS:
            if src.count(line) != 1:
                smoke._fail(f"grouped_lookup.cu no longer has one '{line}'")
            cu = _build.BUILD_DIR / f"grouped_lookup_{name}.{os.getpid()}.cu"
            cu.write_text(src.replace(line, repl))
            self._procs[name] = (_nvcc(cu, cu.with_suffix(".so")), cu.with_suffix(".so"))

    def load(self):
        from repro_torch.kernels import _build

        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        libs = {name: _load(name, *pt) for name, pt in self._procs.items()}
        self.old_bag = libs["parent embedding_bag"].qr_embedding_bag
        self.old_bag.argtypes, self.old_bag.restype = [p] * 6 + [i] * 5 + [p], i
        self.old_grouped = libs["parent grouped_lookup"].grouped_lookup
        self.old_grouped.argtypes = [p, p, i, p, p] + [ll] * 3 + [p] + [ll] * 3 + [p] \
            + [i] * 7 + [p]
        self.old_grouped.restype = i
        self.variants = {}
        for name, _, _ in VARIANTS:
            lib = libs[name]
            for sym, (argtypes, restype) in _build._SIGNATURES["grouped_lookup"].items():
                getattr(lib, sym).argtypes, getattr(lib, sym).restype = argtypes, restype
            self.variants[name] = lib

    def old_kernel(self, rem, quo, mask, w_rem, w_quo, op):
        """The old K3 launch on pre-split int32 ids and a mask in the table
        dtype, all contiguous."""
        import torch

        (b, length), d = rem.shape, w_rem.shape[1]
        out = torch.empty((b, d), dtype=w_rem.dtype, device=w_rem.device)
        code = self.old_bag(rem.data_ptr(), quo.data_ptr(), mask.data_ptr(), w_rem.data_ptr(),
                            w_quo.data_ptr(), out.data_ptr(), b, length, d,
                            int(w_rem.dtype == torch.bfloat16), int(op == "mult"),
                            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            smoke._fail(f"the old K3 launch: CUDA error {code}")
        return out

    def replaced_route(self, idx, mask, w_rem, w_quo, op):
        """The parent's ``ops.qr_bag_lookup`` on a dense pair: split the ids,
        cast and copy ids and mask, launch the old K3."""
        import torch

        m = w_rem.shape[0]
        rem, quo = idx % m, idx // m
        rem, quo = rem.to(torch.int32).contiguous(), quo.to(torch.int32).contiguous()
        return self.old_kernel(rem, quo, mask.to(w_rem.dtype).contiguous(), w_rem, w_quo, op)


def check_parent_bits(torch, builds, grouped_inputs):
    """Grouped K4 (int8 mult and add, f32, bf16), K5 (int8 mult, add) and
    K1 (f32, bf16; mult, add): every launch of this tree's grouped kernel
    is repeated with the same descriptors by the parent's into a second
    output, and the two must be equal bit for bit."""
    from repro_torch.kernels import _build, qr_gather, serve_path

    idx, mask, int8_tables, sparse, dense = grouped_inputs
    real = _build.library
    twins = []

    class Twin:
        def __init__(self, lib):
            self._lib = lib

        def grouped_lookup(self, *a):
            (ptrs, ints, n_tables, ia, ib, idx64, is_b, is_t, is_l, mk, mask_bf16, ms_b, ms_t,
             ms_l, _, b, length, d_out, out_bf16, bag, round_weight, tpb, smem, stream) = a
            if idx64 or mask_bf16 or round_weight:
                smoke._fail("[parent]: a launch outside the parent kernel's contract")
            twin = torch.empty((b, n_tables, d_out), device="cuda",
                               dtype=torch.bfloat16 if out_bf16 else torch.float32)
            twins.append(twin)
            old = builds.old_grouped(ptrs, ints, n_tables, ia, ib, is_b, is_t, is_l, mk, ms_b,
                                     ms_t, ms_l, twin.data_ptr(), b, length, d_out, out_bf16,
                                     bag, tpb, smem, stream)
            return self._lib.grouped_lookup(*a) or old

    twin_lib = Twin(real("grouped_lookup"))
    _build.library = lambda name: twin_lib if name == "grouped_lookup" else real(name)
    bf16 = [t._replace(w_a=t.w_a.bfloat16(), w_b=t.w_b.bfloat16()) for t in dense]
    add = [t._replace(op="add") for t in int8_tables]
    cases = [("K4 int8 mult", lambda: serve_path.fused_serve_pool_grouped(idx, mask, int8_tables)),
             ("K4 int8 add", lambda: serve_path.fused_serve_pool_grouped(idx, mask, add)),
             ("K4 f32", lambda: serve_path.fused_serve_pool_grouped(idx, mask, dense)),
             ("K4 bf16", lambda: serve_path.fused_serve_pool_grouped(idx, mask, bf16)),
             ("K5 int8 mult", lambda: qr_gather.qr_gather_quant_grouped(sparse, int8_tables)),
             ("K5 int8 add", lambda: qr_gather.qr_gather_quant_grouped(sparse, add)),
             ("K1 f32 mult", lambda: qr_gather.qr_gather_grouped(sparse, dense)),
             ("K1 f32 add", lambda: qr_gather.qr_gather_grouped(
                 sparse, [t._replace(op="add") for t in dense])),
             ("K1 bf16 mult", lambda: qr_gather.qr_gather_grouped(sparse, bf16)),
             ("K1 bf16 add", lambda: qr_gather.qr_gather_grouped(
                 sparse, [t._replace(op="add") for t in bf16]))]
    try:
        for name, fn in cases:
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, twins[-1]) or got.dtype != twins[-1].dtype:
                smoke._fail(f"[parent] grouped {name}: max |diff| "
                            f"{smoke._max_err(torch, got, twins[-1]):.3e} against the parent's")
            print(f"  grouped {name} B={got.shape[0]} T={got.shape[1]} D={got.shape[2]}: "
                  "equal to the parent's kernel bit for bit")
    finally:
        _build.library = real
    return [name for name, _ in cases]


def _on_variant(torch, fn, lib, iters):
    """Device ms of ``fn()`` on a variant build and on the port's build,
    timed in turns (variant, port, port, variant) and averaged per build;
    the two must give the same bits."""
    from repro_torch.kernels import _build

    real = _build.library
    times, outs = {True: [], False: []}, {}
    try:
        for on_variant in (True, False, False, True):
            _build.library = (lambda name: lib if name == "grouped_lookup" else real(name)) \
                if on_variant else real
            outs[on_variant] = fn()
            times[on_variant].append(smoke._time_ms(torch, fn, iters))
    finally:
        _build.library = real
    if not torch.equal(outs[True], outs[False]):
        smoke._fail("a variant build gives other bits than the port's build")
    return {"variant_ms": sum(times[True]) / 2, "port_ms": sum(times[False]) / 2}


def time_routes(torch, builds, shapes):
    """The replaced route and the old kernel alone beside the new route, at
    every K3 case; returns their fields by case."""
    from repro_torch.kernels import ops

    fields = {}
    for shape, kind, op in smoke.BAG_CASES:
        idx, mask, wr, wq, m = smoke._bag_case(shapes, shape, kind)
        iters = 50 if shape == "bandwidth" else 200
        rem, quo = (idx % m).to(torch.int32), (idx // m).to(torch.int32)
        weights = mask.to(wr.dtype).contiguous()
        new = ops.qr_bag_lookup(idx, mask, wr, wq, op=op)

        def old(idx=idx, mask=mask, wr=wr, wq=wq, op=op):
            return builds.replaced_route(idx, mask, wr, wq, op)

        def alone(rem=rem, quo=quo, weights=weights, wr=wr, wq=wq, op=op):
            return builds.old_kernel(rem, quo, weights, wr, wq, op)

        for name, fn in (("replaced route", old), ("old kernel", alone)):
            if not torch.equal(fn(), new):
                smoke._fail(f"K3 {shape} {kind} {op}: the {name} differs by "
                            f"{smoke._max_err(torch, fn(), new):.3e}")
        def k3(idx=idx, mask=mask, wr=wr, wq=wq, op=op):
            return ops.qr_bag_lookup(idx, mask, wr, wq, op=op)

        # host µs per call of both routes in turns (new, replaced, replaced,
        # new, ...): the host's clock drifts between and within processes
        host = {"new": [], "replaced": []}
        for r in range(HOST_ROUNDS):
            for name in (("new", "replaced") if r % 2 == 0 else ("replaced", "new")):
                host[name].append(smoke._host_us(torch, k3 if name == "new" else old, 200))
        f = {"replaced_route_ms": smoke._time_ms(torch, old, iters),
             "old_kernel_alone_ms": smoke._time_ms(torch, alone, iters),
             "host_us_in_turns": host,
             "host_us_median": {k: statistics.median(v) for k, v in host.items()},
             "replaced_route_device_ops_per_call": smoke._device_ops_per_call(torch, old)}
        fields[f"{shape} {kind} {op}"] = f
        print(f"  K3 {shape} {kind} {op}: replaced route {f['replaced_route_ms']:.6f} ms, old "
              f"kernel alone {f['old_kernel_alone_ms']:.6f} ms; host us per call in turns, new "
              f"{[round(x, 1) for x in host['new']]} vs replaced "
              f"{[round(x, 1) for x in host['replaced']]}; device operations "
              f"{f['replaced_route_device_ops_per_call']['ops']} per call; same bits")
    return fields


def time_variants(torch, builds, shapes):
    """8 slots against 4 by threads per bag, and the one-table kernel
    parameter against the 40-table one."""
    from repro_torch.kernels import grouped_lookup, ops, qr_gather

    out = {"slots8": {}, "one_table": {}}
    kept = grouped_lookup.WIDE_THREADS_PER_BAG
    for shape in ("bandwidth", "bench"):
        idx, mask, wr, wq, _ = smoke._bag_case(shapes, shape, "f32")
        sweep = {}
        try:
            for tpb in (8, 16, 32):
                grouped_lookup.WIDE_THREADS_PER_BAG = tpb
                sweep[tpb] = _on_variant(
                    torch, lambda: ops.qr_bag_lookup(idx, mask, wr, wq, op="add"),
                    builds.variants["slots8"], 50 if shape == "bandwidth" else 200)
        finally:
            grouped_lookup.WIDE_THREADS_PER_BAG = kept
        out["slots8"][f"{shape} f32 add"] = sweep
        print(f"  K3 {shape} f32 add, 8 slots (variant) vs 4 (port) by threads per bag: {sweep}")

    one = builds.variants["one_table"]
    idx, mask, wr, wq, _ = smoke._bag_case(shapes, "bench", "f32")
    out["one_table"]["K3 bench f32 mult"] = _on_variant(
        torch, lambda: ops.qr_bag_lookup(idx, mask, wr, wq), one, 200)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bm, bq, bd = 2048, 16, 128
    ids = torch.randint(0, bm * bq, (512,), generator=gen, device="cuda", dtype=torch.int32)
    args = (ids % bm, ids // bm, torch.randn((bm, bd), generator=gen, device="cuda"),
            torch.randn((bq, bd), generator=gen, device="cuda"))
    long_args = (args[0].long(), args[1].long(), *args[2:])
    out["one_table"]["K1 bench N=512 int32 ids"] = _on_variant(
        torch, lambda: qr_gather.qr_gather(*args), one, 200)
    out["one_table"]["K1 bench N=512 int64 ids"] = _on_variant(
        torch, lambda: qr_gather.qr_gather(*long_args), one, 200)
    print(f"  one-table kernel parameter (variant) vs 40-table (port): {out['one_table']}")
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", required=True,
                    help="a checkout of eed88fb, the commit before K3's redesign")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_k3_routes: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = smoke._card_line()
    print(card)
    t0 = time.perf_counter()
    builds = Builds(args.parent)
    for name, log in _build.build_all().items():
        smoke._print_registers(name, log)
    builds.load()
    print(f"[build] port, parent and variant builds in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("[parent] grouped K4, K5 and K1 against the parent's grouped kernel")
    _, grouped_inputs = smoke.check_grouped(torch, gen)
    same_bits = check_parent_bits(torch, builds, grouped_inputs)
    shapes = smoke.bag_shapes(torch, gen)
    print("[K3] the new route (chip_smoke.time_bag)")
    new = smoke.time_bag(torch, shapes)
    print("[K3] the replaced route and the old kernel alone")
    replaced = time_routes(torch, builds, shapes)
    print("[variants] 8 slots in flight; a one-table kernel parameter")
    variants = time_variants(torch, builds, shapes)
    print(f"  card: {card}; {time.perf_counter() - t0:.0f} s in all")
    print(json.dumps({"card": card, "grouped_equal_to_parent": same_bits,
                      "k3": {case: {**new[case], **replaced[case]} for case in new},
                      "variants": variants}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
