// CPU baseline for the north-star workload: a from-scratch C++
// implementation of the REFERENCE'S algorithm (spec: /root/reference/
// pair_buck_coul_long_intel.cpp eval loop structure, pppm_intel.cpp
// make_rho/poisson_ik/fieldforce_ik) so BASELINE.md can carry a MEASURED
// Xeon number instead of an estimate.  Single-threaded (this container
// exposes one core); node-level numbers extrapolate by core count with
// the assumption documented in BASELINE.md.
//
// Algorithm (mirrors stock LAMMPS / the reference, not the JAX engine):
//   * binned half neighbor lists with Newton's 3rd law, skin 1.0,
//     rebuilt every 10 steps
//   * buck/coul/long pair kernel: Buckingham exp-6 + Ewald real-space
//     erfc via the Abramowitz-Stegun 5-term polynomial
//   * PPPM ik: order-5 B-spline deposit, radix-2 complex 3D FFT,
//     ik E-field inverse FFTs, spline gather
//   * velocity-Verlet NVE
//
// Usage: baseline_md <binary system file> <nsteps> [--check]
// The system file is written by bench_baseline.py (n, box, x, q, typ,
// per-type-pair A/rho/C, cutoffs, g_ewald, qqrd2e).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <complex>
#include <chrono>

using std::vector;
using cplx = std::complex<double>;

struct Sys {
  int n = 0, ntypes = 0;
  double box[3] = {0, 0, 0};
  vector<double> x, v, f;  // (n,3)
  vector<double> q;
  vector<int> typ;
  vector<double> A, rho, C;  // (ntypes*ntypes)
  double cut = 0, cut_coul = 0, g_ewald = 0, qqrd2e = 0, dt = 0;
  vector<double> mass;  // per type
};

static Sys read_sys(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) { perror("open"); exit(1); }
  Sys s;
  auto rd = [&](void* p, size_t sz, size_t n) {
    if (fread(p, sz, n, fp) != n) { fprintf(stderr, "short read\n"); exit(1); }
  };
  rd(&s.n, 4, 1); rd(&s.ntypes, 4, 1);
  rd(s.box, 8, 3);
  s.x.resize(3 * s.n); s.v.resize(3 * s.n); s.f.assign(3 * s.n, 0.0);
  s.q.resize(s.n); s.typ.resize(s.n);
  rd(s.x.data(), 8, 3 * s.n);
  rd(s.v.data(), 8, 3 * s.n);
  rd(s.q.data(), 8, s.n);
  rd(s.typ.data(), 4, s.n);
  int tt = s.ntypes * s.ntypes;
  s.A.resize(tt); s.rho.resize(tt); s.C.resize(tt);
  rd(s.A.data(), 8, tt); rd(s.rho.data(), 8, tt); rd(s.C.data(), 8, tt);
  rd(&s.cut, 8, 1); rd(&s.cut_coul, 8, 1); rd(&s.g_ewald, 8, 1);
  rd(&s.qqrd2e, 8, 1); rd(&s.dt, 8, 1);
  s.mass.resize(s.ntypes);
  rd(s.mass.data(), 8, s.ntypes);
  fclose(fp);
  return s;
}

// ---------------- neighbor lists (binned, half, Newton) ----------------
struct Neigh {
  vector<int> head, next, list, numneigh, firstneigh;
  int nbinx, nbiny, nbinz;
  double binsz[3];
};

static void build_neigh(const Sys& s, double cutneigh, Neigh& nb) {
  double c2 = cutneigh * cutneigh;
  nb.nbinx = std::max(1, (int)(s.box[0] / cutneigh));
  nb.nbiny = std::max(1, (int)(s.box[1] / cutneigh));
  nb.nbinz = std::max(1, (int)(s.box[2] / cutneigh));
  for (int a = 0; a < 3; a++)
    nb.binsz[a] = s.box[a] / (a == 0 ? nb.nbinx : a == 1 ? nb.nbiny : nb.nbinz);
  int nbins = nb.nbinx * nb.nbiny * nb.nbinz;
  nb.head.assign(nbins, -1);
  nb.next.assign(s.n, -1);
  auto binof = [&](int i) {
    int bx = (int)(s.x[3 * i] / nb.binsz[0]) % nb.nbinx;
    int by = (int)(s.x[3 * i + 1] / nb.binsz[1]) % nb.nbiny;
    int bz = (int)(s.x[3 * i + 2] / nb.binsz[2]) % nb.nbinz;
    if (bx < 0) bx += nb.nbinx;
    if (by < 0) by += nb.nbiny;
    if (bz < 0) bz += nb.nbinz;
    return (bx * nb.nbiny + by) * nb.nbinz + bz;
  };
  for (int i = 0; i < s.n; i++) {
    int b = binof(i);
    nb.next[i] = nb.head[b];
    nb.head[b] = i;
  }
  nb.numneigh.assign(s.n, 0);
  nb.firstneigh.assign(s.n + 1, 0);
  nb.list.clear();
  nb.list.reserve((size_t)s.n * 400);
  // half list: keep pair (i, j) once with j from self/neighbor bins, j > i
  for (int i = 0; i < s.n; i++) {
    double xi = s.x[3 * i], yi = s.x[3 * i + 1], zi = s.x[3 * i + 2];
    int bx = (int)(xi / nb.binsz[0]) % nb.nbinx;
    int by = (int)(yi / nb.binsz[1]) % nb.nbiny;
    int bz = (int)(zi / nb.binsz[2]) % nb.nbinz;
    nb.firstneigh[i] = (int)nb.list.size();
    for (int ox = -1; ox <= 1; ox++)
      for (int oy = -1; oy <= 1; oy++)
        for (int oz = -1; oz <= 1; oz++) {
          int cx = (bx + ox + nb.nbinx) % nb.nbinx;
          int cy = (by + oy + nb.nbiny) % nb.nbiny;
          int cz = (bz + oz + nb.nbinz) % nb.nbinz;
          int b = (cx * nb.nbiny + cy) * nb.nbinz + cz;
          for (int j = nb.head[b]; j >= 0; j = nb.next[j]) {
            if (j <= i) continue;
            double dx = xi - s.x[3 * j];
            double dy = yi - s.x[3 * j + 1];
            double dz = zi - s.x[3 * j + 2];
            dx -= s.box[0] * std::nearbyint(dx / s.box[0]);
            dy -= s.box[1] * std::nearbyint(dy / s.box[1]);
            dz -= s.box[2] * std::nearbyint(dz / s.box[2]);
            if (dx * dx + dy * dy + dz * dz < c2) nb.list.push_back(j);
          }
        }
    nb.numneigh[i] = (int)nb.list.size() - nb.firstneigh[i];
  }
  nb.firstneigh[s.n] = (int)nb.list.size();
}

// ---------------- pair: buck/coul/long ----------------
// A&S 7.1.26 erfc polynomial, the same formula family the reference uses
// (pair_buck_coul_long_intel.cpp:296-309)
static const double EWALD_F = 1.12837917;
static const double EA1 = 0.254829592, EA2 = -0.284496736, EA3 = 1.421413741,
                    EA4 = -1.453152027, EA5 = 1.061405429, EWALD_P = 0.3275911;

static void pair_force(Sys& s, const Neigh& nb, double* evdwl, double* ecoul) {
  double c2lj = s.cut * s.cut, c2c = s.cut_coul * s.cut_coul;
  double ev = 0, ec = 0;
  std::fill(s.f.begin(), s.f.end(), 0.0);
  for (int i = 0; i < s.n; i++) {
    double xi = s.x[3 * i], yi = s.x[3 * i + 1], zi = s.x[3 * i + 2];
    double qi = s.q[i];
    int ti = s.typ[i];
    double fxi = 0, fyi = 0, fzi = 0;
    for (int k = nb.firstneigh[i]; k < nb.firstneigh[i + 1]; k++) {
      int j = nb.list[k];
      double dx = xi - s.x[3 * j];
      double dy = yi - s.x[3 * j + 1];
      double dz = zi - s.x[3 * j + 2];
      dx -= s.box[0] * std::nearbyint(dx / s.box[0]);
      dy -= s.box[1] * std::nearbyint(dy / s.box[1]);
      dz -= s.box[2] * std::nearbyint(dz / s.box[2]);
      double rsq = dx * dx + dy * dy + dz * dz;
      if (rsq >= c2lj && rsq >= c2c) continue;
      double r2inv = 1.0 / rsq;
      double fpair = 0;
      if (rsq < c2lj) {
        int tt = ti * s.ntypes + s.typ[j];
        double r = std::sqrt(rsq);
        double r6inv = r2inv * r2inv * r2inv;
        double rexp = std::exp(-r / s.rho[tt]);
        double buck1 = s.A[tt] / s.rho[tt];
        double forcebuck = buck1 * r * rexp - 6.0 * s.C[tt] * r6inv;
        ev += s.A[tt] * rexp - s.C[tt] * r6inv;
        fpair += forcebuck * r2inv;
      }
      if (rsq < c2c && qi != 0.0) {
        double r = std::sqrt(rsq);
        double grij = s.g_ewald * r;
        double expm2 = std::exp(-grij * grij);
        double t = 1.0 / (1.0 + EWALD_P * grij);
        double erfcv =
            t * (EA1 + t * (EA2 + t * (EA3 + t * (EA4 + t * EA5)))) * expm2;
        double prefactor = s.qqrd2e * qi * s.q[j] / r;
        ec += prefactor * erfcv;
        fpair += prefactor * (erfcv + EWALD_F * grij * expm2) * r2inv;
      }
      fxi += fpair * dx; fyi += fpair * dy; fzi += fpair * dz;
      s.f[3 * j] -= fpair * dx;       // Newton's 3rd law (half list)
      s.f[3 * j + 1] -= fpair * dy;
      s.f[3 * j + 2] -= fpair * dz;
    }
    s.f[3 * i] += fxi; s.f[3 * i + 1] += fyi; s.f[3 * i + 2] += fzi;
  }
  *evdwl = ev;
  *ecoul = ec;
}

// ---------------- PPPM (order 5, ik, radix-2 FFT) ----------------
static void fft1d(cplx* a, int n, int stride, bool inv) {
  // iterative radix-2 Cooley-Tukey on strided data
  static vector<cplx> buf;
  buf.resize(n);
  for (int i = 0; i < n; i++) buf[i] = a[(size_t)i * stride];
  // bit reversal
  for (int i = 1, j = 0; i < n; i++) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(buf[i], buf[j]);
  }
  for (int len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * M_PI / len * (inv ? 1 : -1);
    cplx wl(std::cos(ang), std::sin(ang));
    for (int i = 0; i < n; i += len) {
      cplx w(1.0);
      for (int k = 0; k < len / 2; k++) {
        cplx u = buf[i + k], v = buf[i + k + len / 2] * w;
        buf[i + k] = u + v;
        buf[i + k + len / 2] = u - v;
        w *= wl;
      }
    }
  }
  for (int i = 0; i < n; i++) a[(size_t)i * stride] = buf[i];
}

static void fft3d(vector<cplx>& g, int nx, int ny, int nz, bool inv) {
  for (int y = 0; y < ny; y++)
    for (int z = 0; z < nz; z++) fft1d(&g[(size_t)y * nz + z], nx, ny * nz, inv);
  for (int x = 0; x < nx; x++)
    for (int z = 0; z < nz; z++) fft1d(&g[((size_t)x * ny) * nz + z], ny, nz, inv);
  for (int x = 0; x < nx; x++)
    for (int y = 0; y < ny; y++) fft1d(&g[((size_t)x * ny + y) * nz], nz, 1, inv);
}

struct Pppm {
  int nx, ny, nz;
  vector<double> greens, kx, ky, kz;
  vector<double> rho_c[3];  // per-axis spline weights scratch
  double h[3];
};

static void spline5(double d, double* w) {
  // order-5 cardinal B-spline weights at offsets -2..2, centered coord d
  // in [-0.5, 0.5) (matches rho_coeff Horner evaluation in the reference)
  for (int k = -2; k <= 2; k++) {
    double x = d - k + 2.5;  // argument into M5 on (0,5)
    double m = 0.0;
    // Cox-de Boor closed form per interval of M5
    if (x > 0 && x < 5) {
      auto p4 = [](double t) { return t * t * t * t; };
      m = p4(x);
      if (x > 1) m -= 5 * p4(x - 1);
      if (x > 2) m += 10 * p4(x - 2);
      if (x > 3) m -= 10 * p4(x - 3);
      if (x > 4) m += 5 * p4(x - 4);
      m /= 24.0;
    }
    w[k + 2] = m;
  }
}

static void pppm_setup(const Sys& s, Pppm& p, int nx, int ny, int nz) {
  p.nx = nx; p.ny = ny; p.nz = nz;
  p.h[0] = s.box[0] / nx; p.h[1] = s.box[1] / ny; p.h[2] = s.box[2] / nz;
  p.kx.resize(nx); p.ky.resize(ny); p.kz.resize(nz);
  auto kv = [](int m, int n, double L) {
    int mm = (m > n / 2) ? m - n : m;
    return 2.0 * M_PI * mm / L;
  };
  for (int i = 0; i < nx; i++) p.kx[i] = kv(i, nx, s.box[0]);
  for (int i = 0; i < ny; i++) p.ky[i] = kv(i, ny, s.box[1]);
  for (int i = 0; i < nz; i++) p.kz[i] = kv(i, nz, s.box[2]);
  p.greens.assign((size_t)nx * ny * nz, 0.0);
  double g2 = s.g_ewald * s.g_ewald;
  for (int a = 0; a < nx; a++)
    for (int b = 0; b < ny; b++)
      for (int c = 0; c < nz; c++) {
        double k2 = p.kx[a] * p.kx[a] + p.ky[b] * p.ky[b] + p.kz[c] * p.kz[c];
        if (k2 > 0)
          p.greens[((size_t)a * ny + b) * nz + c] =
              4.0 * M_PI / k2 * std::exp(-k2 / (4.0 * g2));
      }
}

static double pppm_force(Sys& s, Pppm& p) {
  size_t ng = (size_t)p.nx * p.ny * p.nz;
  static vector<cplx> grid, wk;
  static vector<double> ex, ey, ez;
  grid.assign(ng, cplx(0));
  // make_rho: order-5 deposit (pppm_intel.cpp:403-527 algorithm)
  static vector<int> base(3 * s.n);
  static vector<double> w(15 * s.n);
  for (int i = 0; i < s.n; i++) {
    for (int a = 0; a < 3; a++) {
      double u = s.x[3 * i + a] / p.h[a];
      int b = (int)std::nearbyint(u);
      double d = u - b;
      base[3 * i + a] = b;
      spline5(d, &w[15 * i + 5 * a]);
    }
    double qi = s.q[i];
    for (int ox = 0; ox < 5; ox++) {
      int gx = (base[3 * i] + ox - 2) % p.nx; if (gx < 0) gx += p.nx;
      double wx = qi * w[15 * i + ox];
      for (int oy = 0; oy < 5; oy++) {
        int gy = (base[3 * i + 1] + oy - 2) % p.ny; if (gy < 0) gy += p.ny;
        double wxy = wx * w[15 * i + 5 + oy];
        for (int oz = 0; oz < 5; oz++) {
          int gz = (base[3 * i + 2] + oz - 2) % p.nz; if (gz < 0) gz += p.nz;
          grid[((size_t)gx * p.ny + gy) * p.nz + gz] +=
              wxy * w[15 * i + 10 + oz];
        }
      }
    }
  }
  // poisson_ik
  fft3d(grid, p.nx, p.ny, p.nz, false);
  double V = s.box[0] * s.box[1] * s.box[2];
  double elong = 0;
  for (size_t k = 0; k < ng; k++)
    elong += p.greens[k] * std::norm(grid[k]);
  elong *= 0.5 / V * s.qqrd2e;
  // self + background
  double qsq = 0, qs = 0;
  for (int i = 0; i < s.n; i++) { qsq += s.q[i] * s.q[i]; qs += s.q[i]; }
  elong -= s.qqrd2e * s.g_ewald * qsq / std::sqrt(M_PI);
  elong -= s.qqrd2e * M_PI / 2.0 * qs * qs / (s.g_ewald * s.g_ewald * V);
  ex.assign(ng, 0); ey.assign(ng, 0); ez.assign(ng, 0);
  for (int ax = 0; ax < 3; ax++) {
    wk.assign(ng, cplx(0));
    for (int a = 0; a < p.nx; a++)
      for (int b = 0; b < p.ny; b++)
        for (int c = 0; c < p.nz; c++) {
          size_t k = ((size_t)a * p.ny + b) * p.nz + c;
          double kv = ax == 0 ? p.kx[a] : ax == 1 ? p.ky[b] : p.kz[c];
          wk[k] = cplx(0, -kv) * p.greens[k] * grid[k];
        }
    fft3d(wk, p.nx, p.ny, p.nz, true);
    double* dst = ax == 0 ? ex.data() : ax == 1 ? ey.data() : ez.data();
    for (size_t k = 0; k < ng; k++) dst[k] = wk[k].real() / V;
  }
  // fieldforce_ik gather
  for (int i = 0; i < s.n; i++) {
    double fx = 0, fy = 0, fz = 0;
    for (int ox = 0; ox < 5; ox++) {
      int gx = (base[3 * i] + ox - 2) % p.nx; if (gx < 0) gx += p.nx;
      double wx = w[15 * i + ox];
      for (int oy = 0; oy < 5; oy++) {
        int gy = (base[3 * i + 1] + oy - 2) % p.ny; if (gy < 0) gy += p.ny;
        double wxy = wx * w[15 * i + 5 + oy];
        for (int oz = 0; oz < 5; oz++) {
          int gz = (base[3 * i + 2] + oz - 2) % p.nz; if (gz < 0) gz += p.nz;
          double w3 = wxy * w[15 * i + 10 + oz];
          size_t k = ((size_t)gx * p.ny + gy) * p.nz + gz;
          fx += w3 * ex[k]; fy += w3 * ey[k]; fz += w3 * ez[k];
        }
      }
    }
    double qf = s.qqrd2e * s.q[i];
    s.f[3 * i] += qf * fx; s.f[3 * i + 1] += qf * fy; s.f[3 * i + 2] += qf * fz;
  }
  return elong;
}

int main(int argc, char** argv) {
  if (argc < 3) { fprintf(stderr, "usage: %s sys.bin nsteps [gx gy gz]\n", argv[0]); return 1; }
  Sys s = read_sys(argv[1]);
  int nsteps = atoi(argv[2]);
  int gx = argc > 3 ? atoi(argv[3]) : 64;
  int gy = argc > 4 ? atoi(argv[4]) : 64;
  int gz = argc > 5 ? atoi(argv[5]) : 128;
  Pppm pm;
  pppm_setup(s, pm, gx, gy, gz);
  double cutneigh = std::max(s.cut, s.cut_coul) + 1.0;
  Neigh nb;
  build_neigh(s, cutneigh, nb);
  double ev, ec;
  pair_force(s, nb, &ev, &ec);
  double el = pppm_force(s, pm);
  fprintf(stderr, "step 0: evdwl=%.6g ecoul=%.6g elong=%.6g\n", ev, ec, el);

  vector<double> minv(s.n);
  for (int i = 0; i < s.n; i++) minv[i] = 1.0 / s.mass[s.typ[i]];
  // metal units: ftm2v = 1/1.0364e-4
  double ftm2v = 1.0 / 1.0364269e-4;
  double dtf = 0.5 * s.dt * ftm2v, dtv = s.dt;

  auto t0 = std::chrono::steady_clock::now();
  for (int step = 0; step < nsteps; step++) {
    for (int i = 0; i < s.n; i++)
      for (int a = 0; a < 3; a++) {
        s.v[3 * i + a] += dtf * minv[i] * s.f[3 * i + a];
        s.x[3 * i + a] += dtv * s.v[3 * i + a];
      }
    if (step % 10 == 9) {
      for (int i = 0; i < 3 * s.n; i++) {
        int a = i % 3;
        s.x[i] -= s.box[a] * std::floor(s.x[i] / s.box[a]);
      }
      build_neigh(s, cutneigh, nb);
    }
    pair_force(s, nb, &ev, &ec);
    el = pppm_force(s, pm);
    for (int i = 0; i < s.n; i++)
      for (int a = 0; a < 3; a++)
        s.v[3 * i + a] += dtf * minv[i] * s.f[3 * i + a];
  }
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  fprintf(stderr, "final: evdwl=%.6g ecoul=%.6g elong=%.6g\n", ev, ec, el);
  printf("{\"atoms\": %d, \"steps\": %d, \"seconds\": %.3f, "
         "\"atom_steps_per_sec\": %.1f}\n",
         s.n, nsteps, secs, s.n * (double)nsteps / secs);
  return 0;
}
