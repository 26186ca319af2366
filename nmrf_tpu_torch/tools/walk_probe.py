"""Probe of a fault of ``ptxas`` met in B5b's gather kernel (H100, sm_90a).

    python3 -m nmrf_tpu_torch.tools.walk_probe

An interim f 1 step of ``csrc/msda_taps_bwd.cu``'s gather kernel found the
kept taps of a level pixel by walking each tap row's columns between
bounds computed once per row (walk A below); the shipped kernel tests
each tap's cell (walk B).  Both compute the same set: tap t = (ty + r)(2r
+ 1) + tx + r is kept when the cell (py - ty, px - tx) lies on the map and
bit t of its 128-bit mask is set.  This builds the two walks alone, at
``-O3`` and with ``-Xptxas -O1`` and ``-O0``, runs them on random masks at
the swin step's f 1 shape (16 images x 8 heads, 96 x 192, r 5), and counts
the (image, head, pixel) jobs whose set differs from a plain PyTorch
version, with the taps that differ.  It prints one JSON line and exits 0;
it needs the card and ``nvcc``.
"""

import ctypes
import json
import subprocess
import sys

import torch

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
struct Q { int Hl, Wl, r; long long plane; };
__device__ __forceinline__ void set_tap(unsigned long long& lo, unsigned long long& hi, int t) {
  if (t < 64) lo |= 1ull << t;
  else hi |= 1ull << (t - 64);
}
template <int A>
__global__ void walk(const uint32_t* __restrict__ masks, unsigned long long* out, Q p,
                     long long n) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int px = idx % p.Wl, py = (idx / p.Wl) % p.Hl;
  const uint32_t* cm = masks + idx / p.Wl / p.Hl * 4 * p.plane;
  const int S = 2 * p.r + 1;
  unsigned long long lo = 0, hi = 0;
  if (A) {  // each tap row's columns on the map bounded once
    for (int ty = -p.r; ty <= p.r; ++ty) {
      const int cy = py - ty;
      if (cy < 0 || cy >= p.Hl) continue;
      const int t0 = (ty + p.r) * S + p.r;
      const uint32_t* row = cm + static_cast<long long>(cy) * p.Wl + px;
      const int tx1 = min(p.r, px);
      for (int tx = max(-p.r, px - p.Wl + 1); tx <= tx1; ++tx) {
        const int t = t0 + tx;
        if ((row[(t >> 5) * p.plane - tx] >> (t & 31)) & 1u) set_tap(lo, hi, t);
      }
    }
  } else {  // each tap's cell tested
    for (int ty = -p.r, t = 0; ty <= p.r; ++ty) {
      const int cy = py - ty;
      for (int tx = -p.r; tx <= p.r; ++tx, ++t) {
        const int cx = px - tx;
        if (cy >= 0 && cy < p.Hl && cx >= 0 && cx < p.Wl &&
            ((cm[(t >> 5) * p.plane + static_cast<long long>(cy) * p.Wl + cx] >> (t & 31)) & 1u))
          set_tap(lo, hi, t);
      }
    }
  }
  out[2 * idx] = lo;
  out[2 * idx + 1] = hi;
}
extern "C" int run_walk(const void* masks, void* out, int BM, int Hl, int Wl, int r, int a) {
  Q p{Hl, Wl, r, static_cast<long long>(Hl) * Wl};
  const long long n = static_cast<long long>(BM) * Hl * Wl;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  if (a) walk<1><<<blocks, 256>>>(m, o, p, n);
  else walk<0><<<blocks, 256>>>(m, o, p, n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
BUILDS = {"O3": [], "ptxas_O1": ["-Xptxas", "-O1"], "ptxas_O0": ["-Xptxas", "-O0"]}


def build(workdir):
    """{build name: ctypes run_walk} of SOURCE, one nvcc per build, together."""
    from nmrf_tpu_torch.ops import _native

    src = workdir / "walk_probe.cu"
    src.write_text(SOURCE)
    procs = {name: subprocess.Popen(
        [_native._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", *flags, "-o",
         str(workdir / f"walk_probe_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in BUILDS.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"walk_probe {name}: nvcc failed\n{log}")
        fns[name] = ctypes.CDLL(str(workdir / f"walk_probe_{name}.so")).run_walk
    return fns


def plain_taps(masks, r):
    """The kept-tap sets as [BM, Hl, Wl, (2r+1)^2] bool, in PyTorch."""
    BM, _, Hl, Wl = masks.shape
    S = 2 * r + 1
    pad = torch.zeros(BM, 4, Hl + 2 * r, Wl + 2 * r, dtype=masks.dtype, device=masks.device)
    pad[:, :, r:r + Hl, r:r + Wl] = masks
    kept = torch.zeros(BM, Hl, Wl, S * S, dtype=torch.bool, device=masks.device)
    for t in range(S * S):
        ty, tx = t // S - r, t % S - r
        # the cell (py - ty, px - tx), off the map a zero word
        cells = pad[:, t >> 5, r - ty:r - ty + Hl, r - tx:r - tx + Wl]
        kept[..., t] = ((cells >> (t & 31)) & 1).bool()
    return kept


def main():
    from nmrf_tpu_torch.ops import _native

    if not torch.cuda.is_available():
        print("walk_probe: no CUDA device available", file=sys.stderr)
        return 1
    BM, Hl, Wl, r = 16 * 8, 96, 192, 5
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fns = build(_native.BUILD_DIR)
    gen = torch.Generator(device="cuda").manual_seed(0)
    masks = torch.randint(-2**31, 2**31 - 1, (BM, 4, Hl, Wl), generator=gen,
                          device="cuda", dtype=torch.int32)
    want = plain_taps(masks, r)
    bit = torch.arange(64, device="cuda")
    S = 2 * r + 1
    result = {}
    for name, fn in fns.items():
        for walk, a in (("A", 1), ("B", 0)):
            out = torch.zeros(BM * Hl * Wl * 2, dtype=torch.int64, device="cuda")
            rc = fn(ctypes.c_void_p(masks.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                    BM, Hl, Wl, r, a)
            if rc:
                raise RuntimeError(f"walk_probe {name} walk {walk}: CUDA error {rc}")
            words = out.view(BM, Hl, Wl, 2)
            got = torch.cat([(words[..., 0:1] >> bit) & 1,
                             (words[..., 1:2] >> bit)[..., :S * S - 64] & 1], -1).bool()
            wrong = (got != want).nonzero()  # [image x head, py, px, tap]
            ty, tx = wrong[:, 3] // S - r, wrong[:, 3] % S - r
            cy, cx = wrong[:, 1] - ty, wrong[:, 2] - tx
            result[f"{name} walk {walk}"] = {
                "jobs": BM * Hl * Wl,
                "wrong_jobs": int((got != want).any(-1).sum()),
                "extra_taps": int((got & ~want).sum()),
                "missing_taps": int((~got & want).sum()),
                "wrong_taps (ty, tx)": sorted(set(zip(ty.tolist(), tx.tolist()))),
                "their_cells_on_the_map": int(((cy >= 0) & (cy < Hl) & (cx >= 0)
                                               & (cx < Wl)).sum()),
                "their_cell_rows": sorted(set(cy.tolist()))[:8],
                "their_pixels_x": sorted(set(wrong[:, 2].tolist()))[:8]}
    nvcc = subprocess.run([_native._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"nvcc": nvcc, "card": card, "walks": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
