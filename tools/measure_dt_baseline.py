"""Measured dense-tracking baseline: time the reference's OWN addBCGC.

Stage-3 speedup claims were self-referential until round 4 — the reference's
dense tracking had never been timed in this environment. Its full binary
cannot run here: TRW-S v1.3 is NOT in-tree (CMakeLists.txt:12 is a path
placeholder), FLANN and GSL are absent. What CAN be timed, unmodified, is
the per-hypothesis energy kernel `addBCGC` (dense_tracking.cpp:240-349) —
the hot loop of hypothesis scoring (SURVEY.md §3.4: per hypothesis x
(skip+1)^2 window x O(Jets^2) visible-pair terms), evaluated at every
hypothesis creation, perturbation, and neighbor proposal.

Method (same discipline as tools/measure_mt_baseline.py): extract
`insideImg` + the timing globals + `addBCGC` + `addOC` verbatim from
dense_tracking.cpp and `bilinearInterp(float*)` from utils.cpp into an
out-of-tree TU at BUILD TIME (nothing is copied into the repo), compile
with the reference's own hypothesis.h / parameter_list.cpp / image.c at
-O3 -msse4, and time addBCGC on the bench workload shape (480x270, Jets=5,
skip=1, occlusion masks off). GSL headers are replaced by empty stubs —
hypothesis.h only includes them; the functions live in hypothesis.cpp,
which this harness does not compile.

The JSON reports the per-call cost AND a per-final-pair projection under an
EXPLICIT call-count model (stated in the JSON): pixels x (initial
hypotheses + alternations x accepted proposals) energy evaluations, the
reference's own structure at the bench cfg (acc_alternate=5,
acc_neigh_hyp=5, acc_skip_pixel=1). TRW-S message passing and FLANN
sampling come ON TOP of this in the real binary, so the projection is a
LOWER bound on the reference's per-final cost — every x-vs-reference claim
derived from it is conservative. Single thread: the reference parallelizes
over final pairs (dense_tracking.cpp:726), never inside one.

Usage: python tools/measure_dt_baseline.py [--calls 200000]
Writes dt_baseline.json to the temporary directory.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
BUILD = Path(tempfile.gettempdir()) / "dt_oracle_build"
RESULT = Path(tempfile.gettempdir()) / "dt_baseline.json"

H, W, JETS, SKIP = 270, 480, 5, 1

MAIN_CPP = r"""
// Harness main: random smooth observation/derivative stacks at the bench
// shape, a pool of realistic hypotheses, and a timed addBCGC loop.
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "extracted_energy.h"

static void fill_smooth(color_image_t* im, std::mt19937& rng) {
    std::uniform_real_distribution<float> u(0.f, 255.f);
    float* planes[3] = {im->c1, im->c2, im->c3};
    for (int c = 0; c < 3; ++c) {
        for (int y = 0; y < im->height; ++y)
            for (int x = 0; x < im->width; ++x)
                planes[c][y * im->stride + x] = u(rng);
        // cheap blur so bilinear taps look like images, not white noise
        for (int y = 1; y < im->height - 1; ++y)
            for (int x = 1; x < im->width - 1; ++x)
                planes[c][y * im->stride + x] = 0.25f * (
                    planes[c][(y - 1) * im->stride + x]
                    + planes[c][(y + 1) * im->stride + x]
                    + planes[c][y * im->stride + x - 1]
                    + planes[c][y * im->stride + x + 1]);
    }
}

int main(int argc, char** argv) {
    const int calls = argc > 1 ? atoi(argv[1]) : 200000;
    const int H = 270, W = 480, JETS = 5, SKIP = 1;
    std::mt19937 rng(0);

    std::vector<color_image_t*> obs(JETS + 1), dx(JETS + 1), dy(JETS + 1);
    for (int j = 0; j <= JETS; ++j) {
        obs[j] = color_image_new(W, H); fill_smooth(obs[j], rng);
        dx[j] = color_image_new(W, H);  fill_smooth(dx[j], rng);
        dy[j] = color_image_new(W, H);  fill_smooth(dy[j], rng);
    }

    ParameterList params;
    params.Jets = JETS;

    std::uniform_real_distribution<double> px(8.0, W - 9.0);
    std::uniform_real_distribution<double> py(8.0, H - 9.0);
    std::normal_distribution<double> nz(0.0, 0.3);
    const int NH = 4096;
    std::vector<hypothesis*> hyps(NH);
    for (int i = 0; i < NH; ++i) {
        double* fx = new double[JETS];
        double* fy = new double[JETS];
        for (int j = 0; j < JETS; ++j) {
            fx[j] = 1.5 * (j + 1) + nz(rng);     // the bench jet motion
            fy[j] = -0.8 * (j + 1) + nz(rng);
        }
        hyps[i] = new hypothesis(JETS, fx, fy, px(rng), py(rng));
        hyps[i]->occlusions = new int[JETS + 2];
        for (int j = 0; j <= JETS + 1; ++j) hyps[i]->occlusions[j] = 0;
    }

    // warmup
    volatile double sink = 0;
    for (int i = 0; i < 1000; ++i)
        sink += addBCGC(hyps[i % NH], obs.data(), dx.data(), dy.data(),
                        0.1, 1.0, SKIP, params, NULL);

    auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < calls; ++i)
        sink += addBCGC(hyps[i % NH], obs.data(), dx.data(), dy.data(),
                        0.1, 1.0, SKIP, params, NULL)
              + addOC(hyps[i % NH], 0.1, 0.5, params);
    auto t1 = std::chrono::steady_clock::now();
    double dt = std::chrono::duration<double>(t1 - t0).count();
    std::printf("{\"calls\": %d, \"total_s\": %.4f, \"us_per_call\": %.3f, "
                "\"sink\": %.1f}\n", calls, dt, 1e6 * dt / calls,
                (double)sink);
    return 0;
}
"""

HEADER = r"""
#ifndef EXTRACTED_ENERGY_H_
#define EXTRACTED_ENERGY_H_
#include <opencv2/core.hpp>
#include "epic_flow_extended/image.h"
#include "utils/parameter_list.h"
#include "utils/hypothesis.h"
using namespace std;
using namespace cv;
double bilinearInterp(double x, double y, const float* fct, int height,
                      int width, int stride);
float addBCGC(hypothesis* h, color_image_t const* const* obs,
              color_image_t const* const* dx, color_image_t const* const* dy,
              double acc_bc, double acc_gc, int skip, ParameterList& params,
              const Mat* occlusion_masks);
float addOC(hypothesis* h, double acc_occ, double acc_temporal_occ,
            ParameterList& params);
#endif
"""

GSL_STUB = "// empty GSL stub: hypothesis.h includes this header but only\n" \
           "// hypothesis.cpp (not compiled here) calls into GSL\n"


def _extract(src: str, start_re: str) -> str:
    """Verbatim function extraction: from the first line matching start_re
    through the matching close brace at column 0."""
    m = re.search(start_re, src, re.M)
    assert m, start_re
    end = src.index("\n}", m.start())
    return src[m.start():end + 2] + "\n"


def build() -> Path:
    binary = BUILD / "dt_energy"
    if binary.exists():
        return binary
    BUILD.mkdir(parents=True, exist_ok=True)
    ep = BUILD / "epic_flow_extended"
    ep.mkdir(exist_ok=True)
    for f in ("image.c", "image.h", "array_types.h"):
        shutil.copy(REFERENCE / "epic_flow_extended" / f, ep / f)
    (BUILD / "utils").mkdir(exist_ok=True)
    for f in ("parameter_list.h", "parameter_list.cpp", "hypothesis.h"):
        shutil.copy(REFERENCE / "utils" / f, BUILD / "utils" / f)
    shutil.copytree(REFERENCE / "penalty_functions",
                    BUILD / "penalty_functions", dirs_exist_ok=True)
    (BUILD / "gsl").mkdir(exist_ok=True)
    (BUILD / "gsl" / "gsl_fit.h").write_text(GSL_STUB)
    (BUILD / "gsl" / "gsl_multifit.h").write_text(GSL_STUB)

    dt_src = (REFERENCE / "dense_tracking.cpp").read_text()
    utils_src = (REFERENCE / "utils" / "utils.cpp").read_text()
    extracted = "\n".join([
        '#include "extracted_energy.h"',
        "#include <ctime>",
        _extract(dt_src, r"^inline bool insideImg"),
        _extract(utils_src,
                 r"^double bilinearInterp\(double x, double y, const float"),
        "double dt_warp_time = 0, dt_med_time = 0, dt_sum_time = 0;",
        _extract(dt_src, r"^float addBCGC"),
        _extract(dt_src, r"^float addOC"),
    ])
    (BUILD / "extracted_energy.cpp").write_text(extracted)
    (BUILD / "extracted_energy.h").write_text(HEADER)
    (BUILD / "main.cpp").write_text(MAIN_CPP)

    cvflags = subprocess.run(["pkg-config", "--cflags", "opencv4"],
                             capture_output=True, text=True,
                             check=True).stdout.split()
    cvlibs = ["-lopencv_core"]
    cxx = ["g++", "-std=c++14", "-fPIC", "-O3", "-msse4",
           "-I", str(BUILD)] + cvflags
    cc = ["gcc", "-fPIC", "-O3", "-msse4", "-I", str(BUILD)]
    objs = []
    for src, comp in (("epic_flow_extended/image.c", cc),
                      ("utils/parameter_list.cpp", cxx),
                      ("extracted_energy.cpp", cxx),
                      ("main.cpp", cxx)):
        obj = BUILD / (Path(src).stem + ".o")
        subprocess.run(comp + ["-c", str(BUILD / src), "-o", str(obj)],
                       check=True, cwd=BUILD)
        objs.append(str(obj))
    subprocess.run(["g++", "-o", str(binary)] + objs + cvlibs + ["-lm"],
                   check=True)
    return binary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200000)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    binary = build()
    best = None
    for _ in range(args.runs):
        out = subprocess.run([str(binary), str(args.calls)], check=True,
                             capture_output=True, text=True).stdout
        rec = json.loads(out.strip().splitlines()[-1])
        if best is None or rec["us_per_call"] < best["us_per_call"]:
            best = rec

    # explicit call-count model for the per-final projection (reference
    # structure at the bench cfg): every hypothesis insertion computes the
    # full energy — per pixel of the skip_pixel=1 grid: ~2 initial
    # hypotheses (consistent accumulation + EPIC-interpolated,
    # dense_tracking.cpp:1203-1350) + acc_alternate x acc_neigh_hyp
    # accepted neighbor proposals re-anchored and re-scored (:1434-1583)
    pixels = (H // (SKIP + 1)) * (W // (SKIP + 1))
    evals_per_pixel = 2 + 5 * 5
    calls_per_final = pixels * evals_per_pixel
    t_energy_final = calls_per_final * best["us_per_call"] * 1e-6
    result = {
        "us_per_addBCGC_call": best["us_per_call"],
        "calls_timed": best["calls"],
        "height": H, "width": W, "jets": JETS, "skip_pixel": SKIP,
        "call_count_model": {
            "pixels": pixels,
            "evals_per_pixel": evals_per_pixel,
            "formula": "pixels * (2 initial + 5 alternations * 5 accepted "
                       "proposals)",
            "calls_per_final": calls_per_final,
        },
        "energy_s_per_final_1core": round(t_energy_final, 2),
        "note": "LOWER bound on the reference's per-final cost: TRW-S "
                "message passing, FLANN sampling, NMS, accumulation and "
                "I/O come on top; TRW-S/FLANN/GSL are absent from this "
                "environment so only the energy kernel is timeable. "
                "Single thread (the reference parallelizes over finals, "
                "dense_tracking.cpp:726).",
    }
    RESULT.write_text(json.dumps(result) + "\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
