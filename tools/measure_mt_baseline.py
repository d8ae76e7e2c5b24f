"""Measured multi-frame baseline: time ONE real reference jet.

Builds an out-of-tree harness around the reference's *unmodified*
`variational_mt.cpp` + `variational_aux_mt.cpp` + `solver.c` + `image.c`
(+ `parameter_list.cpp`) and times `Variational_MT::variational` on the
exact bench workload (`tools/scene.py` `moving_sequence`, 480x270, S=3,
5 pyramid layers, 10 alter x 10 outer x 30 SOR) with `slow_flow_occlusion_reasoning=0`
— GCO is absent in this environment, so its header is replaced by an
abort()ing stub that the occlusion-off path never reaches. With occlusions
off the reference keeps BOTH data-term directions active per pixel
(variational_mt.cpp:292-320 gates half of them when reasoning is on), so
the measured time is, if anything, biased *against* this claim's favor only
through the skipped GCO solves; everything else is the full per-jet cost.

The harness main() is our own; the numerical code that runs is the
reference's, compiled with its own flags (-O3 -msse4, single thread — the
reference parallelizes over jets, never inside one; slow_flow.cpp:706).

Usage: python tools/measure_mt_baseline.py [--runs 2]
Prints one JSON line {"t_jet_s": ..., "jets_per_sec_core": ...} and writes
it to mt_baseline.json in the temporary directory.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
BUILD = Path(tempfile.gettempdir()) / "mt_oracle_build"
RESULT = Path(tempfile.gettempdir()) / "mt_baseline.json"

H, W, S = 270, 480, 3

GCO_STUB = """\
// Minimal stand-in for the GCO v3.0 header so variational_aux_mt.cpp links
// with slow_flow_occlusion_reasoning=0 (optimizeOcc is never called).
// Calling any method aborts: this stub must never execute.
#ifndef GCO_STUB_H_
#define GCO_STUB_H_
#include <cstdlib>
#include <cstdio>
struct GCException {
    void Report() {}
};
struct GCoptimizationGridGraph {
    GCoptimizationGridGraph(int, int, int) { die(); }
    void setDataCost(int, int, float) { die(); }
    void setSmoothCost(int, int, float) { die(); }
    void expansion(int) { die(); }
    int whatLabel(int) { die(); return 0; }
    static void die() {
        std::fprintf(stderr, "GCO stub called: occlusion reasoning must be off\\n");
        std::abort();
    }
};
#endif
"""

CONFIG_H = """\
#ifndef CONFIGURATION_H_
#define CONFIGURATION_H_
#include <iostream>
#include <string>
#define IDENT(x) x
#define XSTR(x) #x
#define STR(x) XSTR(x)
#define CONCAT(x,y) STR(IDENT(x)IDENT(y))
const std::string DEEPMATCHING_PATH = "";
#define MIDDLEBURY_PATH(file) CONCAT(./gco_stub,file)
#define GCO_PATH(file)        CONCAT(./gco_stub,file)
#define TRWS_PATH(file)       CONCAT(./gco_stub,file)
const std::string SOURCE_FILE = __FILE__;
const std::string SOURCE_PATH = SOURCE_FILE.substr(0, SOURCE_FILE.rfind("/") + 1);
#endif
"""

MAIN_CPP = """\
// Harness: load a raw [F,3,H,W] float32 window, run the reference's
// Variational_MT::variational once at the bench configuration, print the
// wall-clock seconds of the minimization alone.
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <vector>
#include "epic_flow_extended/variational_mt.h"

int main(int argc, char** argv) {
    if (argc < 5) { std::fprintf(stderr, "usage: %s raw F H W\\n", argv[0]); return 2; }
    const char* raw = argv[1];
    const int F = atoi(argv[2]), H = atoi(argv[3]), W = atoi(argv[4]);

    std::vector<float> buf((size_t)F * 3 * H * W);
    std::ifstream in(raw, std::ios::binary);
    if (!in.read((char*)buf.data(), buf.size() * sizeof(float))) {
        std::fprintf(stderr, "failed to read %s\\n", raw); return 2;
    }

    std::vector<color_image_t*> seq(F);
    for (int f = 0; f < F; ++f) {
        seq[f] = color_image_new(W, H);
        float* planes[3] = {seq[f]->c1, seq[f]->c2, seq[f]->c3};
        for (int c = 0; c < 3; ++c)
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x)
                    planes[c][y * seq[f]->stride + x] =
                        buf[(((size_t)f * 3 + c) * H + y) * W + x];
    }

    ParameterList params;
    params.insert("verbose", "0", true);
    params.insert("slow_flow_S", "3", true);
    params.insert("slow_flow_alpha", "4.0", true);
    params.insert("slow_flow_gamma", "6.0", true);
    params.insert("slow_flow_delta", "1.0", true);
    params.insert("slow_flow_rho_0", "1", true);
    params.insert("slow_flow_rho_1", "1", true);
    params.insert("slow_flow_omega_0", "0", true);
    params.insert("slow_flow_omega_1", "2", true);
    params.insert("slow_flow_dataterm", "1", true);
    params.insert("slow_flow_smoothing", "1", true);
    params.insert("slow_flow_layers", "5", true);
    params.insert("slow_flow_p_scale", "0.9", true);
    params.insert("slow_flow_niter_alter", "10", true);
    params.insert("slow_flow_niter_graphc", "10", true);
    params.insert("slow_flow_niter_outer", "10", true);
    params.insert("slow_flow_thres_outer", "1e-5", true);
    params.insert("slow_flow_niter_inner", "1", true);
    params.insert("slow_flow_thres_inner", "1e-5", true);
    params.insert("slow_flow_niter_solver", "30", true);
    params.insert("slow_flow_sor_omega", "1.9", true);
    params.insert("slow_flow_occlusion_reasoning", "0", true);
    params.insert("slow_flow_occlusion_penalty", "0.1", true);
    params.insert("slow_flow_occlusion_alpha", "0.1", true);
    params.insert("slow_flow_robust_color", "1", true);
    params.insert("slow_flow_robust_color_eps", "0.001", true);
    params.insert("slow_flow_robust_color_truncation", "0.5", true);
    params.insert("slow_flow_robust_reg", "1", true);
    params.insert("slow_flow_robust_reg_eps", "0.001", true);
    params.insert("slow_flow_robust_reg_truncation", "0.5", true);

    normalize(seq.data(), F, params);

    image_t *wx = image_new(W, H), *wy = image_new(W, H);
    image_erase(wx); image_erase(wy);

    Variational_MT mt;
    auto t0 = std::chrono::steady_clock::now();
    mt.variational(wx, wy, seq.data(), params);
    auto t1 = std::chrono::steady_clock::now();
    double dt = std::chrono::duration<double>(t1 - t0).count();

    // median recovered u over the interior as a sanity check
    std::vector<float> us;
    for (int y = 8; y < H - 8; y += 3)
        for (int x = 8; x < W - 8; x += 3)
            us.push_back(wx->data[y * wx->stride + x]);
    std::nth_element(us.begin(), us.begin() + us.size() / 2, us.end());
    std::printf("{\\"t_jet_s\\": %.3f, \\"median_u\\": %.3f}\\n",
                dt, us[us.size() / 2]);
    return 0;
}
"""


def make_window() -> Path:
    from scene import moving_sequence

    f = 2 * (S - 1) + 1
    seq = moving_sequence(f, H, W, 1.5, -0.8, seed=0)
    raw = BUILD / "window.raw"
    seq.astype(np.float32).tofile(raw)
    return raw


def build() -> Path:
    binary = BUILD / "mt_jet"
    if binary.exists():
        return binary
    BUILD.mkdir(parents=True, exist_ok=True)
    ep = BUILD / "epic_flow_extended"
    if ep.exists():
        shutil.rmtree(ep)
    ep.mkdir()
    for f in ("image.c", "image.h", "array_types.h", "solver.c", "solver.h",
              "variational_mt.cpp", "variational_mt.h",
              "variational_aux_mt.cpp", "variational_aux_mt.h"):
        shutil.copy(REFERENCE / "epic_flow_extended" / f, ep / f)
    (BUILD / "utils").mkdir(exist_ok=True)
    for f in ("parameter_list.h", "parameter_list.cpp"):
        shutil.copy(REFERENCE / "utils" / f, BUILD / "utils" / f)
    shutil.copytree(REFERENCE / "penalty_functions",
                    BUILD / "penalty_functions", dirs_exist_ok=True)
    (BUILD / "gco_stub").mkdir(exist_ok=True)
    (BUILD / "gco_stub" / "GCoptimization.h").write_text(GCO_STUB)
    (BUILD / "configuration.h").write_text(CONFIG_H)
    (BUILD / "main.cpp").write_text(MAIN_CPP)

    # variational_mt.cpp includes ../utils/utils.h only for conversion
    # helpers it redefines as static methods; utils.h drags in the absent
    # Middlebury devkit, so point the include at nothing.
    mt = (ep / "variational_mt.cpp").read_text()
    mt = mt.replace('#include "../utils/utils.h"', "#include <algorithm>")
    (ep / "variational_mt.cpp").write_text(mt)

    cvflags = subprocess.run(["pkg-config", "--cflags", "opencv4"],
                             capture_output=True, text=True,
                             check=True).stdout.split()
    cvlibs = ["-lopencv_core", "-lopencv_imgproc", "-lopencv_highgui",
              "-lopencv_imgcodecs"]
    cxx = ["g++", "-std=c++14", "-fPIC", "-Wno-all", "-O3", "-msse4",
           "-I", str(BUILD)] + cvflags
    cc = ["gcc", "-fPIC", "-O3", "-msse4", "-I", str(BUILD)]
    objs = []
    for src, comp in (("epic_flow_extended/image.c", cc),
                      ("epic_flow_extended/solver.c", cc),
                      ("epic_flow_extended/variational_mt.cpp", cxx),
                      ("epic_flow_extended/variational_aux_mt.cpp", cxx),
                      ("utils/parameter_list.cpp", cxx),
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
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()

    binary = build()
    raw = make_window()
    times, med = [], None
    for _ in range(args.runs):
        t0 = time.perf_counter()
        out = subprocess.run(
            [str(binary), str(raw), str(2 * (S - 1) + 1), str(H), str(W)],
            check=True, capture_output=True, text=True).stdout
        times.append(time.perf_counter() - t0)
        med = json.loads(out.strip().splitlines()[-1])
    t_jet = med["t_jet_s"]
    result = {
        "t_jet_s": t_jet,
        "jets_per_sec_core": round(1.0 / t_jet, 5),
        "median_u": med["median_u"],
        "height": H, "width": W, "S": S,
        "config": "bench.py full config, occlusion_reasoning=0",
        "note": "single thread = the reference's per-jet cost "
                "(OpenMP only spreads jets across cores)",
    }
    RESULT.write_text(json.dumps(result) + "\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
