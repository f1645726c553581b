/* RANSAC-matcher golden harness: runs the UNMODIFIED reference
 * RandomNormalMatching / PDFMatching / TSD_PDFMatching (compiled
 * straight from /root/reference/src with the deterministic rand shim
 * golden/shim/detrand.h and the exact-1-NN flann stand-in
 * golden/shim/flann/flann.hpp) on a binary input scene and serializes
 * each matcher's Trace (per-candidate scores, Trace.cpp:144-390) plus
 * the winning transforms.
 *
 * Input layout (little-endian, written by golden/gen_ransac_inputs.py):
 *   i32 N
 *   f64 M[N][2], u8 maskM[N], f64 S[N][2], u8 maskS[N]
 *   u32 trials, f64 epsThresh, u32 sizeControlSet, f64 phiMax,
 *   f64 resolution
 *   f64 zhit, zphi, zshort, zmax, zrand, percentagePointsInC,
 *       rangemax, sigphi, sighit, lamshort, maxAngleDiff
 *   f64 zrandTsd, f64 Tsensor[9]
 *   u32 seed
 *   f64 cellSize, i32 layoutPart, i32 layoutGrid, f64 maxTrunc,
 *   f64 angRes, f64 phiMin, f64 maxRange, f64 minRange, f64 lowRefl,
 *   f64 modelRanges[N]
 *
 * The TSD matcher's grid is built by PUSHING the model scan (like the
 * live loop, ThreadMapping::initPush) rather than reloading a stored
 * grid: TsdGrid's text-reload path leaves the partition halo rows
 * unpropagated, which changes boundary-row interpolations vs the
 * pushed in-memory state the matcher actually sees in production.
 *
 * Usage: ransac_harness input.bin outdir
 * Writes outdir/{exp,pdf,tsd}/ trace folders + outdir/tbest.bin
 * (3 matrices x 9 f64, row-major, in exp/pdf/tsd order).
 */

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "obvision/registration/ransacMatching/PDFMatching.h"
#include "obvision/registration/ransacMatching/RandomNormalMatching.h"
#include "obvision/registration/ransacMatching/TSD_PDFMatching.h"
#include "obvision/registration/ransacMatching/TwinPointMatching.h"
#include "obvision/reconstruct/grid/SensorPolar2D.h"
#include "obvision/reconstruct/grid/TsdGrid.h"

/* the global deterministic rand stream (declared in detrand.h, which
 * is force-included into every TU) */
unsigned int det_rand_state = 1u;
int det_rand(void) /* 31-bit LCG, glibc TYPE_0 constants */
{
  det_rand_state = det_rand_state * 1103515245u + 12345u;
  return (int)(det_rand_state & 0x7fffffffu);
}
void det_srand(unsigned int) { /* srand(time(NULL)) must not disturb
                                  the replayable stream */ }
void det_reset(unsigned int seed) { det_rand_state = seed; }

using namespace obvious;

int main(int argc, char** argv)
{
  if(argc < 3)
  {
    std::fprintf(stderr, "usage: %s input.bin outdir\n", argv[0]);
    return 2;
  }
  FILE* f = std::fopen(argv[1], "rb");
  if(!f)
  {
    std::perror("input");
    return 2;
  }
#define RD(ptr, n) \
  if(std::fread(ptr, sizeof(*(ptr)), n, f) != (size_t)(n)) return 3
  int N;
  RD(&N, 1);
  std::vector<double> Mbuf(N * 2), Sbuf(N * 2);
  std::vector<unsigned char> mM(N), mS(N);
  RD(Mbuf.data(), N * 2);
  RD(mM.data(), N);
  RD(Sbuf.data(), N * 2);
  RD(mS.data(), N);
  unsigned int trials, sizeControlSet, seed;
  double epsThresh, phiMax, resolution;
  double zhit, zphi, zshort, zmax, zrand, pctC, rangemax, sigphi, sighit,
      lamshort, maxAngleDiff, zrandTsd;
  double Ts[9];
  RD(&trials, 1);
  RD(&epsThresh, 1);
  RD(&sizeControlSet, 1);
  RD(&phiMax, 1);
  RD(&resolution, 1);
  RD(&zhit, 1);
  RD(&zphi, 1);
  RD(&zshort, 1);
  RD(&zmax, 1);
  RD(&zrand, 1);
  RD(&pctC, 1);
  RD(&rangemax, 1);
  RD(&sigphi, 1);
  RD(&sighit, 1);
  RD(&lamshort, 1);
  RD(&maxAngleDiff, 1);
  RD(&zrandTsd, 1);
  RD(Ts, 9);
  RD(&seed, 1);
  double cellSize, maxTrunc, angRes, phiMin, maxRange, minRange, lowRefl;
  int layoutPart, layoutGrid;
  RD(&cellSize, 1);
  RD(&layoutPart, 1);
  RD(&layoutGrid, 1);
  RD(&maxTrunc, 1);
  RD(&angRes, 1);
  RD(&phiMin, 1);
  RD(&maxRange, 1);
  RD(&minRange, 1);
  RD(&lowRefl, 1);
  std::vector<double> modelRanges(N);
  RD(modelRanges.data(), N);
  std::fclose(f);

  Matrix M(N, 2, Mbuf.data());
  Matrix S(N, 2, Sbuf.data());
  std::vector<bool> dummy; /* (avoid vector<bool>; matchers want bool*) */
  bool* maskM = new bool[N];
  bool* maskS = new bool[N];
  for(int i = 0; i < N; i++)
  {
    maskM[i] = mM[i] != 0;
    maskS[i] = mS[i] != 0;
  }

  std::string outdir = argv[2];
  double tbest[3][9];

  auto store = [&](int k, Matrix& T) {
    for(int r = 0; r < 3; r++)
      for(int c = 0; c < 3; c++)
        tbest[k][r * 3 + c] = T(r, c);
  };

  {
    RandomNormalMatching m(trials, epsThresh, sizeControlSet);
    m.activateTrace();
    det_reset(seed);
    Matrix T = m.match(&M, maskM, NULL, &S, maskS, phiMax, 1.5,
                       resolution);
    m.serializeTrace((outdir + "/exp").c_str());
    store(0, T);
  }

  {
    PDFMatching m(trials, epsThresh, sizeControlSet, zhit, zphi, zshort,
                  zmax, zrand, pctC, rangemax, sigphi, sighit, lamshort,
                  maxAngleDiff, 0.5);
    m.activateTrace();
    det_reset(seed);
    Matrix T = m.match(&M, maskM, NULL, &S, maskS, phiMax, 1.5,
                       resolution);
    m.serializeTrace((outdir + "/pdf").c_str());
    store(1, T);
  }

  {
    TsdGrid grid(cellSize, (EnumTsdGridLayout)layoutPart,
                 (EnumTsdGridLayout)layoutGrid);
    grid.setMaxTruncation(maxTrunc);
    SensorPolar2D sensor(N, angRes, phiMin, maxRange, minRange, lowRefl);
    Matrix Tsensor0(3, 3, Ts);
    sensor.transform(&Tsensor0);
    sensor.setRealMeasurementData(modelRanges.data(), 1.0);
    sensor.setStandardMask();
    grid.push(&sensor);
    TSD_PDFMatching m(grid, trials, epsThresh, sizeControlSet, zrandTsd);
    m.activateTrace();
    det_reset(seed);
    Matrix Tsensor(3, 3, Ts);
    Matrix T = m.match(Tsensor, &M, maskM, NULL, &S, maskS, phiMax, 1.5,
                       resolution);
    m.serializeTrace((outdir + "/tsd").c_str());
    store(2, T);
  }

  /* TwinPointMatching (TwinPointMatching.cpp:89-381): not reachable
   * from the reference's mode enum, but built and traced for parity
   *.  Signature differs (no NM argument);
   * transMax = 1.5 as for the other matchers above. */
  double tbest_twin[9];
  {
    TwinPointMatching m(trials, epsThresh, sizeControlSet);
    m.activateTrace();
    det_reset(seed);
    Matrix T = m.match(&M, maskM, &S, maskS, phiMax, 1.5, resolution);
    /* TwinPointMatching.h:51 re-declares serializeTrace but never
     * defines it; the base implementation does the work */
    m.RandomMatching::serializeTrace((outdir + "/twin").c_str());
    for(int r = 0; r < 3; r++)
      for(int c = 0; c < 3; c++)
        tbest_twin[r * 3 + c] = T(r, c);
  }
  {
    std::string tw = outdir + "/tbest_twin.bin";
    FILE* o = std::fopen(tw.c_str(), "wb");
    std::fwrite(tbest_twin, sizeof(double), 9, o);
    std::fclose(o);
  }

  std::string tb = outdir + "/tbest.bin";
  FILE* o = std::fopen(tb.c_str(), "wb");
  std::fwrite(tbest, sizeof(double), 27, o);
  std::fclose(o);
  std::printf("ransac harness ok\n");
  delete[] maskM;
  delete[] maskS;
  return 0;
}
