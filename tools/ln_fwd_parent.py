"""The row LayerNorm forward kernel (B5) of this tree against another
tree's, on one card.

    python3 tools/ln_fwd_parent.py DIR

DIR is a checkout of another commit (e.g. ``git archive <commit>``
unpacked); only its ``paddle_tpu_torch/csrc/`` is read. Builds that tree's
``layer_norm.cu`` with this tree's ``nvcc`` flags into this tree's
``paddle_tpu_torch/_build/``, and this tree's as ``layer_norm_fwd`` does.
At the rows the port sends B5 (GPT-medium's training rows [4096, 1024] in
float32 and bfloat16, BERT-base's [4096, 768], the serving prefill's
[1024, 1024], a speculative round's [40, 1024] and the decode step's
[8, 1024]) it checks this tree's output against ``layer_norm_fwd_plain``,
says whether the two trees' y, mu and rstd are bit for bit equal, and
times their ``ln_fwd`` in the order other, this, this, other
(CUDA-graph replays, as chip_smoke.py times), beside ``F.layer_norm`` and
the bytes bound. Writes the rows to ``chiprun_out/ln_fwd_parent.json``.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import bound_ms, close, time_ms  # noqa: E402

SHAPES = (((4096, 1024), torch.float32), ((4096, 768), torch.float32),
          ((4096, 1024), torch.bfloat16), ((1024, 1024), torch.float32),
          ((40, 1024), torch.float32), ((8, 1024), torch.float32))


def _parent_lib(build, parent: Path):
    """``ln_fwd`` of the other tree's layer_norm.cu, built into this
    tree's build directory."""
    csrc = parent / "paddle_tpu_torch" / "csrc"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libln_fwd_parent.so"
    subprocess.run([build.nvcc(), *build.FLAGS, "-I", str(csrc), "-o",
                    str(out), str(csrc / "layer_norm.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ln_fwd.argtypes = [p, p, p, p, p, p, i, i, f, i, p]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path,
                    help="a checkout whose B5 to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ln_fwd_parent: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    fns = {"parent": _parent_lib(_build, args.parent).ln_fwd,
           "change": _build.library("layer_norm", ln._SIGNATURES).ln_fwd}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for (R, D), dtype in SHAPES:
        x = torch.randn(R, D, device="cuda", generator=gen).to(dtype)
        w, b = (torch.randn(D, device="cuda", generator=gen)
                for _ in range(2))
        shape = f"[{R},{D}] {str(dtype)[6:]}"
        outs, calls = {}, {}
        for name, fn in fns.items():
            o = outs[name] = (torch.empty_like(x),
                              torch.empty(R, device="cuda"),
                              torch.empty(R, device="cuda"))

            def call(fn=fn, o=o):
                _build.check(fn(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(), R, D,
                    1e-5, _build.DTYPE_CODE[dtype],
                    torch.cuda.current_stream().cuda_stream), "ln_fwd")

            calls[name] = call
            call()
        torch.cuda.synchronize()
        ref = ln.layer_norm_fwd_plain(x, w, b)
        errs = [close(a, r, dtype if i == 0 else torch.float32)
                for i, (a, r) in enumerate(zip(outs["change"], ref))]
        if not all(ok for _, ok in errs):
            raise SystemExit(f"ln_fwd_parent: FAILED: {shape} disagrees "
                             "with its plain version")
        same = all(torch.equal(a, c) for a, c in zip(outs["parent"],
                                                      outs["change"]))
        times = {"parent": [], "change": []}
        for name in ("parent", "change", "change", "parent"):
            times[name].append(time_ms(calls[name]))
        lib_ms = time_ms(lambda: tF.layer_norm(x, (D,), w.to(dtype),
                                               b.to(dtype), 1e-5))
        bms, by = bound_ms(2 * R * D * x.element_size() + 2 * D * 4
                           + 2 * R * 4, 8 * R * D, torch.float32)
        print(f"{shape}: other / this / this / other "
              f"{times['parent'][0]:.4f} {times['change'][0]:.4f} "
              f"{times['change'][1]:.4f} {times['parent'][1]:.4f} ms; "
              f"F.layer_norm {lib_ms:.4f} ms; bound {bms:.6f} ms ({by}); "
              f"path kN = {ln.layer_norm_fwd_path(x, w, b)}; y, mu, rstd "
              f"bit-equal: {same}")
        out.append(dict(shape=shape, parent_ms=times["parent"],
                        change_ms=times["change"], bit_equal=same,
                        library_ms=lib_ms, bound_ms=bms, bound_by=by))
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "ln_fwd_parent.json").write_text(json.dumps(
        dict(card=card, rows=out), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
