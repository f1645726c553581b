/* Golden-file generator: runs the ACTUAL reference implementation
 * (compiled unmodified from /root/reference/src — see Makefile) on a
 * scripted scenario and dumps exact float64 state for the parity tests in
 * tests/test_reference_parity.py.
 *
 * Exercised reference paths:
 *   TsdGrid::push                 TsdGrid.cpp:217-284
 *   TsdGridComponent::isInRange   TsdGridComponent.cpp:43-124
 *   TsdGridPartition::addTsd      TsdGridPartition.h:170-212
 *   TsdGrid::propagateBorders     TsdGrid.cpp:372-427
 *   TsdGrid::freeFootprint        TsdGrid.cpp:609-638
 *   SensorPolar2D::setStandardMask SensorPolar2D.cpp:59-98
 *   RayCastPolar2D::calcCoordsFromCurrentViewMask  RayCastPolar2D.cpp:113-192
 *   RayCastAxisAligned2D::calcCoords               RayCastAxisAligned2D.cpp:13-105
 *   TsdGrid::storeGrid            TsdGrid.cpp:548-607
 *
 * Input: scenario text file (see golden/gen_inputs.py).
 * Output: tagged binary arrays (name, dtype, dims, payload) + the
 * storeGrid text file.
 *
 * The access-specifier override below exists ONLY to dump per-cell fusion
 * weights and per-partition _initWeight (the reference exposes tsd but
 * not weight); it changes no behavior and no object layout under g++.
 */
#define private public
#define protected public

#include "obvision/reconstruct/grid/RayCastAxisAligned2D.h"
#include "obvision/reconstruct/grid/RayCastPolar2D.h"
#include "obvision/reconstruct/grid/SensorPolar2D.h"
#include "obvision/reconstruct/grid/TsdGrid.h"

#undef private
#undef protected

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

using namespace obvious;

static FILE* g_out = NULL;

static void dump_array(const char* name, char dtype, unsigned ndim,
                       const uint32_t* dims, const void* payload)
{
  uint32_t nl = (uint32_t)strlen(name);
  fwrite(&nl, 4, 1, g_out);
  fwrite(name, 1, nl, g_out);
  fwrite(&dtype, 1, 1, g_out);
  uint32_t nd = ndim;
  fwrite(&nd, 4, 1, g_out);
  size_t total = 1;
  for(unsigned i = 0; i < ndim; i++)
  {
    fwrite(&dims[i], 4, 1, g_out);
    total *= dims[i];
  }
  size_t esz = dtype == 'f' ? 8 : (dtype == 'i' ? 4 : 1);
  fwrite(payload, esz, total, g_out);
}

static void dump_f64(const char* name, const std::vector<double>& v,
                     uint32_t d0, uint32_t d1 = 0)
{
  uint32_t dims[2] = {d0, d1};
  dump_array(name, 'f', d1 ? 2 : 1, dims, v.data());
}

static void dump_i32(const char* name, const std::vector<int32_t>& v,
                     uint32_t d0, uint32_t d1 = 0)
{
  uint32_t dims[2] = {d0, d1};
  dump_array(name, 'i', d1 ? 2 : 1, dims, v.data());
}

static void dump_u8(const char* name, const std::vector<uint8_t>& v,
                    uint32_t d0, uint32_t d1 = 0)
{
  uint32_t dims[2] = {d0, d1};
  dump_array(name, 'b', d1 ? 2 : 1, dims, v.data());
}

/* Reassemble the partitioned field into dense [H, W] cell arrays
 * (interior cells only — halos are the propagateBorders copies of
 * neighbor interiors).  Cells of uninitialized partitions dump as NaN
 * with weight 0, matching the JAX framework's dense representation. */
static void dump_grid(TsdGrid* grid, const std::string& tag)
{
  int H = grid->getCellsY();
  int W = grid->getCellsX();
  int P = (int)grid->getPartitionSize();
  int TY = H / P, TX = W / P;
  TsdGridPartition*** parts = grid->getPartitions();

  std::vector<double> tsd((size_t)H * W), wgt((size_t)H * W);
  std::vector<int32_t> state((size_t)TY * TX);
  std::vector<double> initw((size_t)TY * TX);

  for(int ty = 0; ty < TY; ty++)
    for(int tx = 0; tx < TX; tx++)
    {
      TsdGridPartition* p = parts[ty][tx];
      int32_t st = p->isInitialized() ? 2 : (p->isEmpty() ? 1 : 0);
      state[(size_t)ty * TX + tx] = st;
      initw[(size_t)ty * TX + tx] = p->_initWeight;
      for(int cy = 0; cy < P; cy++)
        for(int cx = 0; cx < P; cx++)
        {
          size_t idx = (size_t)(ty * P + cy) * W + (tx * P + cx);
          if(p->isInitialized())
          {
            tsd[idx] = p->_grid[cy][cx].tsd;
            wgt[idx] = p->_grid[cy][cx].weight;
          }
          else
          {
            tsd[idx] = NAN;
            wgt[idx] = 0.0;
          }
        }
    }
  dump_f64((tag + ".tsd").c_str(), tsd, H, W);
  dump_f64((tag + ".weight").c_str(), wgt, H, W);
  dump_i32((tag + ".state").c_str(), state, TY, TX);
  dump_f64((tag + ".initw").c_str(), initw, TY, TX);
}

int main(int argc, char** argv)
{
  if(argc < 4)
  {
    fprintf(stderr,
            "usage: %s scenario.txt out.bin store_grid.txt\n", argv[0]);
    return 1;
  }
  std::ifstream in(argv[1]);
  if(!in)
  {
    fprintf(stderr, "cannot open %s\n", argv[1]);
    return 1;
  }
  g_out = fopen(argv[2], "wb");
  if(!g_out)
  {
    fprintf(stderr, "cannot open %s\n", argv[2]);
    return 1;
  }

  std::string kw;
  double cellSize, maxTrunc;
  int layoutPart, layoutGrid;
  in >> kw >> cellSize >> layoutPart >> layoutGrid >> maxTrunc;

  unsigned size;
  double angRes, phiMin, maxRange, minRange, lowReflectivityRange;
  in >> kw >> size >> angRes >> phiMin >> maxRange >> minRange >>
      lowReflectivityRange;

  TsdGrid* grid = new TsdGrid(cellSize, (EnumTsdGridLayout)layoutPart,
                              (EnumTsdGridLayout)layoutGrid);
  grid->setMaxTruncation(maxTrunc);

  /* NOTE: Sensor::setTransformation updates only _T, NOT the ray map
   * (Sensor.cpp:101-105) — the live system always moves the sensor with
   * Sensor::transform() (ThreadLocalize.cpp:397,502), which rotates
   * _rays along.  To match that semantics exactly (and avoid the live
   * system's pose-accumulation roundoff), a FRESH sensor is constructed
   * per pose and transformed once: _T = I*P and _rays = R(P)*rays_local,
   * both single multiplications. */
  SensorPolar2D* sensor = NULL;
#define FRESH_SENSOR(Tpose)                                            \
  do                                                                   \
  {                                                                    \
    delete sensor;                                                     \
    sensor = new SensorPolar2D(size, angRes, phiMin, maxRange,         \
                               minRange, lowReflectivityRange);        \
    sensor->transform(&(Tpose));                                       \
  } while(0)

  in >> kw; // footprint
  std::string fp;
  in >> fp;
  if(fp != "none")
  {
    obfloat center[2];
    double w, h;
    center[0] = atof(fp.c_str());
    in >> center[1] >> w >> h;
    grid->freeFootprint(center, w, h);
    dump_grid(grid, "after_footprint");
  }

  int npush;
  in >> kw >> npush;
  std::vector<double> ranges(size);
  double Tv[9];
  for(int p = 0; p < npush; p++)
  {
    in >> kw; // pose
    for(int i = 0; i < 9; i++) in >> Tv[i];
    in >> kw; // ranges
    for(unsigned i = 0; i < size; i++) in >> ranges[i];

    Matrix T(3, 3, Tv);
    FRESH_SENSOR(T);
    sensor->setRealMeasurementData(ranges.data(), 1.0);
    sensor->setStandardMask();

    /* dump the masked measurement pipeline output once per scan */
    {
      double* d = sensor->getRealMeasurementData();
      bool* m = sensor->getRealMeasurementMask();
      std::vector<double> dv(d, d + size);
      std::vector<uint8_t> mv(size);
      for(unsigned i = 0; i < size; i++) mv[i] = m[i] ? 1 : 0;
      char buf[64];
      snprintf(buf, sizeof buf, "scan%02d.data", p);
      dump_f64(buf, dv, size);
      snprintf(buf, sizeof buf, "scan%02d.mask", p);
      dump_u8(buf, mv, size);
    }

    grid->push(sensor);
    char tag[64];
    snprintf(tag, sizeof tag, "after_push%02d", p);
    dump_grid(grid, tag);
  }

  /* polar raycasts from query poses over the final grid */
  int nquery;
  in >> kw >> nquery;
  RayCastPolar2D raycaster;
  std::vector<double> coords(2 * size), normals(2 * size);
  std::vector<bool> dummy;
  for(int q = 0; q < nquery; q++)
  {
    in >> kw;
    for(int i = 0; i < 9; i++) in >> Tv[i];
    Matrix T(3, 3, Tv);
    FRESH_SENSOR(T);
    bool* mask = new bool[size];
    std::fill(coords.begin(), coords.end(), 0.0);
    std::fill(normals.begin(), normals.end(), 0.0);
    unsigned cnt = raycaster.calcCoordsFromCurrentViewMask(
        grid, sensor, coords.data(), normals.data(), mask);
    std::vector<uint8_t> mv(size);
    for(unsigned i = 0; i < size; i++) mv[i] = mask[i] ? 1 : 0;
    delete[] mask;
    char buf[64];
    snprintf(buf, sizeof buf, "ray%02d.coords", q);
    dump_f64(buf, coords, size, 2);
    snprintf(buf, sizeof buf, "ray%02d.normals", q);
    dump_f64(buf, normals, size, 2);
    snprintf(buf, sizeof buf, "ray%02d.mask", q);
    dump_u8(buf, mv, size);
    std::vector<int32_t> cv(1, (int32_t)cnt);
    snprintf(buf, sizeof buf, "ray%02d.cnt", q);
    dump_i32(buf, cv, 1);
  }

  /* axis-aligned surface extraction (ThreadGrid path) */
  {
    int H = grid->getCellsY(), W = grid->getCellsX();
    RayCastAxisAligned2D axis;
    std::vector<double> acoords((size_t)2 * H * W, 0.0);
    /* unwritten cells keep -1 ("unknown"); the reference publishes
     * whatever the preallocated buffer held for never-visited cells */
    std::vector<char> occ((size_t)H * W, -1);
    unsigned cnt = 0; /* counts DOUBLES (events*2), RayCastAxisAligned2D.cpp:57 */
    axis.calcCoords(grid, acoords.data(), NULL, &cnt, occ.data());
    std::vector<int32_t> cv(1, (int32_t)cnt);
    dump_i32("axis.cnt", cv, 1);
    acoords.resize(cnt);
    dump_f64("axis.coords", acoords, cnt / 2, 2);
    std::vector<uint8_t> occ_u(occ.begin(), occ.end());
    dump_u8("axis.occ", occ_u, H, W);
  }

  grid->storeGrid(argv[3]);

  fclose(g_out);
  delete sensor;
  delete grid;
  printf("golden data written to %s\n", argv[2]);
  return 0;
}
