// Single-thread C++ baseline replica of demuxlet's doublet pair-search pass.
//
// The reference (statgen/demuxlet) publishes no benchmark numbers
// (BASELINE.md), so the baseline is MEASURED: this program reimplements the
// exact algorithmic structure of the reference's hot loop — the per-cell
// doublet pair search of cmd_cram_demuxlet.cpp:542-709 — on a synthetic
// workload:
//   * gpAB[i][j*nv*9 + k*9 + l*3 + m] = gps[i][j][l] * gps[i][k][m]
//     precomputed per SNP (reference :542-560, the nsnps*nv^2*9 f64 tensor)
//   * per (cell, SNP): per-UMI mixture products pGs[a][l][m] with the
//     running global-max renormalization (reference :600-640)
//   * +1e-6 / max-renormalize (reference :643-663)
//   * llksAB[j][k][a] += log(sum_lm gpAB * pGs) for all j,k,a (ref :671-684)
//   * llks00[a] += log(sum_lm gp0*gp0 * pGs)              (ref :700-709)
//
// No code is copied from the reference; this is a from-scratch implementation
// of the same loop nest for timing purposes only (the device engine's real
// correctness oracle is oracle/numpy_oracle.py + golden tests).
//
// Usage: ref_pairsearch <ncells> <nsnps_per_cell> <numis_per_snp> <nv>
//                       <nalpha> <nsnps_total> [seed]
// Prints one JSON line: {"seconds": S, "cells": N, "barcodes_per_s": R}

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <vector>

static uint64_t rng_state = 0x9E3779B97F4A7C15ull;
static inline uint64_t splitmix64() {
  uint64_t z = (rng_state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}
static inline double urand() { return (splitmix64() >> 11) * 0x1.0p-53; }
static inline uint32_t uirand(uint32_t n) { return (uint32_t)(splitmix64() % n); }

int main(int argc, char** argv) {
  if (argc < 7) {
    fprintf(stderr,
            "usage: %s ncells snps_per_cell umis_per_snp nv nalpha nsnps "
            "[seed]\n",
            argv[0]);
    return 2;
  }
  const int ncells = atoi(argv[1]);
  const int spc = atoi(argv[2]);
  const int ups = atoi(argv[3]);
  const int nv = atoi(argv[4]);
  const int nAlpha = atoi(argv[5]);
  const int nsnps = atoi(argv[6]);
  if (argc > 7) rng_state = (uint64_t)atoll(argv[7]);

  // Phred LUTs (PhredHelper.cpp:24-55 semantics: phred2Err[0..1]=0.75).
  double phred2Err[256], phred2Mat[256];
  for (int i = 0; i < 256; ++i) {
    phred2Err[i] = (i > 1) ? pow(10.0, -0.1 * i) : 0.75;
    phred2Mat[i] = 1.0 - phred2Err[i];
  }
  std::vector<double> gridAlpha(nAlpha);
  for (int a = 0; a < nAlpha; ++a)
    gridAlpha[a] = (nAlpha == 1) ? 0.0 : 0.5 * a / (nAlpha - 1);

  // Genotype posteriors: random, normalized per (snp, sample).
  std::vector<double> gps((size_t)nsnps * nv * 3);
  std::vector<double> gp0((size_t)nsnps * 3);
  for (int i = 0; i < nsnps; ++i) {
    double s0 = 0, s1 = 0, s2 = 0;
    for (int j = 0; j < nv; ++j) {
      double a = urand() + 1e-3, b = urand() + 1e-3, c = urand() + 1e-3;
      double s = a + b + c;
      double* g = &gps[((size_t)i * nv + j) * 3];
      g[0] = a / s; g[1] = b / s; g[2] = c / s;
      s0 += g[0]; s1 += g[1]; s2 += g[2];
    }
    gp0[(size_t)i * 3 + 0] = s0 / nv;
    gp0[(size_t)i * 3 + 1] = s1 / nv;
    gp0[(size_t)i * 3 + 2] = s2 / nv;
  }

  // Synthetic per-cell pileup: spc random SNPs, ups UMIs each.
  std::vector<int32_t> cell_snps((size_t)ncells * spc);
  std::vector<uint8_t> umi_allele((size_t)ncells * spc * ups);
  std::vector<uint8_t> umi_qual((size_t)ncells * spc * ups);
  for (size_t z = 0; z < cell_snps.size(); ++z) cell_snps[z] = uirand(nsnps);
  for (size_t z = 0; z < umi_allele.size(); ++z) {
    umi_allele[z] = (uint8_t)uirand(2);
    umi_qual[z] = (uint8_t)(13 + uirand(28));  // minBQ=13 .. capBQ=40
  }

  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);

  // ---- timed region: the reference's pass-2 structure ----
  // gpAB precompute (reference :542-560).
  std::vector<double> gpAB((size_t)nsnps * nv * nv * 9);
  std::vector<double> gp00((size_t)nsnps * 9);
  for (int i = 0; i < nsnps; ++i) {
    const double* G = &gps[(size_t)i * nv * 3];
    for (int j = 0; j < nv; ++j)
      for (int k = 0; k < nv; ++k) {
        double* o = &gpAB[(((size_t)i * nv + j) * nv + k) * 9];
        for (int l = 0; l < 3; ++l)
          for (int m = 0; m < 3; ++m) o[l * 3 + m] = G[j * 3 + l] * G[k * 3 + m];
      }
    const double* z = &gp0[(size_t)i * 3];
    for (int l = 0; l < 3; ++l)
      for (int m = 0; m < 3; ++m) gp00[(size_t)i * 9 + l * 3 + m] = z[l] * z[m];
  }

  const int nPG = nAlpha * 9;
  std::vector<double> pGs(nPG);
  std::vector<double> llksAB((size_t)nv * nv * nAlpha);
  std::vector<double> llks00(nAlpha);
  double sink = 0.0;

  for (int c = 0; c < ncells; ++c) {
    for (auto& v : llksAB) v = 0.0;
    for (auto& v : llks00) v = 0.0;
    for (int si = 0; si < spc; ++si) {
      const int isnp = cell_snps[(size_t)c * spc + si];
      for (int p = 0; p < nPG; ++p) pGs[p] = 1.0;
      // per-UMI mixture products + running global max renorm (ref :600-640)
      for (int u = 0; u < ups; ++u) {
        const size_t off = ((size_t)c * spc + si) * ups + u;
        const int al = umi_allele[off];
        const int bq = umi_qual[off];
        const double pR = (al == 0) ? phred2Mat[bq] : phred2Err[bq] / 3.0;
        const double pA = (al == 1) ? phred2Mat[bq] : phred2Err[bq] / 3.0;
        double maxPG = 0.0;
        for (int a = 0; a < nAlpha; ++a) {
          const double alpha = gridAlpha[a];
          for (int l = 0; l < 3; ++l)
            for (int m = 0; m < 3; ++m) {
              const double p = 0.5 * l + (m - l) * 0.5 * alpha;
              double& t = pGs[a * 9 + l * 3 + m];
              t *= (pR * (1.0 - p) + pA * p);
              if (t > maxPG) maxPG = t;
            }
        }
        for (int p = 0; p < nPG; ++p) pGs[p] /= maxPG;
      }
      // +1e-6 and max renorm (ref :643-663)
      double maxPG = 0.0;
      for (int p = 0; p < nPG; ++p) {
        pGs[p] += 1e-6;
        if (pGs[p] > maxPG) maxPG = pGs[p];
      }
      for (int p = 0; p < nPG; ++p) pGs[p] /= maxPG;
      // accumulate llksAB (ref :671-684) — THE hot loop
      const double* AB = &gpAB[(size_t)isnp * nv * nv * 9];
      for (int j = 0; j < nv; ++j)
        for (int k = 0; k < nv; ++k) {
          const double* o = &AB[((size_t)j * nv + k) * 9];
          for (int a = 0; a < nAlpha; ++a) {
            const double* t = &pGs[a * 9];
            double s = 0.0;
            for (int q = 0; q < 9; ++q) s += o[q] * t[q];
            llksAB[((size_t)j * nv + k) * nAlpha + a] += log(s);
          }
        }
      // llks00 (ref :700-709)
      const double* O = &gp00[(size_t)isnp * 9];
      for (int a = 0; a < nAlpha; ++a) {
        const double* t = &pGs[a * 9];
        double s = 0.0;
        for (int q = 0; q < 9; ++q) s += O[q] * t[q];
        llks00[a] += log(s);
      }
    }
    sink += llksAB[0] + llks00[0];
  }
  // ---- end timed region ----

  clock_gettime(CLOCK_MONOTONIC, &t1);
  double secs = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
  fprintf(stderr, "# sink=%g\n", sink);
  printf("{\"seconds\": %.6f, \"cells\": %d, \"barcodes_per_s\": %.3f}\n", secs,
         ncells, ncells / secs);
  return 0;
}
