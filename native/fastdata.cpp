// fastdata — native LAMMPS data-file section parser.
//
// The runtime around the device compute path stays native where the
// reference's is (its whole stack is C++): this is the data-loader piece.
// Python (io/data_reader.py) parses the small header, allocates numpy
// buffers, and hands them here to fill; large Atoms/Velocities/Bonds
// sections parse at ~100x CPython's line loop.  Python remains the
// fallback when the shared library is absent.
//
// C ABI only (ctypes binding; no pybind11 in this image).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <string>
#include <vector>

namespace {

struct Reader {
    FILE* f = nullptr;
    char buf[65536];

    explicit Reader(const char* path) { f = std::fopen(path, "rb"); }
    ~Reader() { if (f) std::fclose(f); }

    // next non-empty line with comments stripped; returns false on EOF
    bool next(char*& line) {
        while (std::fgets(buf, sizeof(buf), f)) {
            char* hash = std::strchr(buf, '#');
            if (hash) *hash = '\0';
            char* p = buf;
            while (*p && std::isspace((unsigned char)*p)) ++p;
            char* e = p + std::strlen(p);
            while (e > p && std::isspace((unsigned char)e[-1])) --e;
            *e = '\0';
            if (*p) { line = p; return true; }
        }
        return false;
    }
};

bool is_section(const char* line, const char* name) {
    size_t n = std::strlen(name);
    return std::strncmp(line, name, n) == 0 &&
           (line[n] == '\0' || std::isspace((unsigned char)line[n]));
}

const char* kSections[] = {
    "Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
    "Impropers", "Pair Coeffs", "PairIJ Coeffs", "Bond Coeffs",
    "Angle Coeffs", "Dihedral Coeffs", "Improper Coeffs",
};

int section_id(const char* line) {
    for (size_t i = 0; i < sizeof(kSections) / sizeof(*kSections); ++i)
        if (is_section(line, kSections[i])) return (int)i;
    return -1;
}

// fast field splitter (strtod/strtol advance the pointer)
inline double rd(char*& p) { return std::strtod(p, &p); }
inline long ri(char*& p) { return std::strtol(p, &p, 10); }

}  // namespace

extern "C" {

// style: 0=atomic, 1=charge, 2=full
// arrays are caller-allocated with the header-derived sizes; image may be
// null-filled when columns are absent.  Returns 0 on success, negative
// error codes otherwise.
int lbi_parse_data(
    const char* path, int style,
    double* x,        // (n_atoms, 3)
    double* v,        // (n_atoms, 3), zero-filled by caller
    double* q,        // (n_atoms,)
    int* typ,         // (n_atoms,), 0-based out
    int* mol,         // (n_atoms,), 0-based out
    int* image,       // (n_atoms, 3)
    double* mass,     // (n_types,)
    int* bonds,       // (n_bonds, 3) [type, i, j] 0-based
    int* angles,      // (n_angles, 4)
    int* dihedrals,   // (n_dihedrals, 5) — may be null when none
    int* impropers,   // (n_impropers, 5) — may be null when none
    long n_atoms, long n_bonds, long n_angles, long n_types,
    long n_dihedrals, long n_impropers)
{
    Reader r(path);
    if (!r.f) return -1;
    char* line;
    int sec = -1;
    while (r.next(line)) {
        int sid = section_id(line);
        if (sid >= 0) { sec = sid; continue; }
        if (sec < 0) continue;  // header region
        char* p = line;
        switch (sec) {
            case 0: {  // Masses
                long t = ri(p);
                if (t < 1 || t > n_types) return -2;
                mass[t - 1] = rd(p);
                break;
            }
            case 1: {  // Atoms
                long id = ri(p);
                if (id < 1 || id > n_atoms) return -3;
                long a = id - 1;
                if (style == 2) mol[a] = (int)(ri(p) - 1);
                typ[a] = (int)(ri(p) - 1);
                if (style >= 1) q[a] = rd(p);
                x[3 * a + 0] = rd(p);
                x[3 * a + 1] = rd(p);
                x[3 * a + 2] = rd(p);
                // optional image flags
                char* save = p;
                long ix = std::strtol(p, &p, 10);
                if (p != save) {
                    image[3 * a + 0] = (int)ix;
                    image[3 * a + 1] = (int)ri(p);
                    image[3 * a + 2] = (int)ri(p);
                }
                break;
            }
            case 2: {  // Velocities
                long id = ri(p);
                if (id < 1 || id > n_atoms) return -4;
                long a = id - 1;
                v[3 * a + 0] = rd(p);
                v[3 * a + 1] = rd(p);
                v[3 * a + 2] = rd(p);
                break;
            }
            case 3: {  // Bonds
                long id = ri(p);
                if (id < 1 || id > n_bonds) return -5;
                long b = id - 1;
                bonds[3 * b + 0] = (int)(ri(p) - 1);
                bonds[3 * b + 1] = (int)(ri(p) - 1);
                bonds[3 * b + 2] = (int)(ri(p) - 1);
                break;
            }
            case 4: {  // Angles
                long id = ri(p);
                if (id < 1 || id > n_angles) return -6;
                long a = id - 1;
                angles[4 * a + 0] = (int)(ri(p) - 1);
                angles[4 * a + 1] = (int)(ri(p) - 1);
                angles[4 * a + 2] = (int)(ri(p) - 1);
                angles[4 * a + 3] = (int)(ri(p) - 1);
                break;
            }
            case 5: {  // Dihedrals
                if (!dihedrals) break;
                long id = ri(p);
                if (id < 1 || id > n_dihedrals) return -7;
                long d = id - 1;
                for (int c = 0; c < 5; ++c)
                    dihedrals[5 * d + c] = (int)(ri(p) - 1);
                break;
            }
            case 6: {  // Impropers
                if (!impropers) break;
                long id = ri(p);
                if (id < 1 || id > n_impropers) return -8;
                long d = id - 1;
                for (int c = 0; c < 5; ++c)
                    impropers[5 * d + c] = (int)(ri(p) - 1);
                break;
            }
            default:
                break;  // coeff sections stay in python
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// fastwrite — native trajectory / data writers (the IO side of the
// runtime; the reference's dump/write_data machinery is host C++ too).
// One buffered fwrite per frame; %.8g float formatting matches the
// python writer (io/dump.py) so outputs are interchangeable.

extern "C" {

// lammpstrj frame: id type x y z vx vy vz rows.  Returns 0 on success.
int write_lammpstrj_frame(const char* path, int append, long step, long n,
                          const double* lo, const double* hi,
                          const double* x, const double* v,
                          const int* typ) {
    FILE* f = std::fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    std::string out;
    out.reserve(80 * (size_t)n + 256);
    char tmp[256];
    std::snprintf(tmp, sizeof tmp,
                  "ITEM: TIMESTEP\n%ld\nITEM: NUMBER OF ATOMS\n%ld\n"
                  "ITEM: BOX BOUNDS pp pp pp\n", step, n);
    out += tmp;
    for (int ax = 0; ax < 3; ++ax) {
        std::snprintf(tmp, sizeof tmp, "%.16e %.16e\n", lo[ax], hi[ax]);
        out += tmp;
    }
    out += "ITEM: ATOMS id type x y z vx vy vz\n";
    for (long i = 0; i < n; ++i) {
        std::snprintf(tmp, sizeof tmp,
                      "%ld %d %.8g %.8g %.8g %.8g %.8g %.8g\n",
                      i + 1, typ[i] + 1,
                      x[3 * i], x[3 * i + 1], x[3 * i + 2],
                      v[3 * i], v[3 * i + 1], v[3 * i + 2]);
        out += tmp;
    }
    size_t put = std::fwrite(out.data(), 1, out.size(), f);
    std::fclose(f);
    return put == out.size() ? 0 : -2;
}

// Atoms/Velocities body of a LAMMPS data file (header written by python).
// style: 0 atomic, 1 charge, 2 full.  Returns 0 on success.
int write_data_body(const char* path, int style, long n,
                    const double* x, const double* v, const double* q,
                    const int* typ, const int* mol, const int* image) {
    FILE* f = std::fopen(path, "ab");
    if (!f) return -1;
    std::string out;
    out.reserve(140 * (size_t)n + 64);
    char tmp[320];
    for (long i = 0; i < n; ++i) {
        int nc;
        if (style == 0)
            nc = std::snprintf(tmp, sizeof tmp, "%ld %d ", i + 1,
                               typ[i] + 1);
        else if (style == 1)
            nc = std::snprintf(tmp, sizeof tmp, "%ld %d %.16e ", i + 1,
                               typ[i] + 1, q[i]);
        else
            nc = std::snprintf(tmp, sizeof tmp, "%ld %d %d %.16e ", i + 1,
                               mol[i] + 1, typ[i] + 1, q[i]);
        out.append(tmp, nc);
        nc = std::snprintf(tmp, sizeof tmp, "%.16e %.16e %.16e %d %d %d\n",
                           x[3 * i], x[3 * i + 1], x[3 * i + 2],
                           image[3 * i], image[3 * i + 1],
                           image[3 * i + 2]);
        out.append(tmp, nc);
    }
    out += "\nVelocities\n\n";
    for (long i = 0; i < n; ++i) {
        int nc = std::snprintf(tmp, sizeof tmp, "%ld %.16e %.16e %.16e\n",
                               i + 1, v[3 * i], v[3 * i + 1], v[3 * i + 2]);
        out.append(tmp, nc);
    }
    size_t put = std::fwrite(out.data(), 1, out.size(), f);
    std::fclose(f);
    return put == out.size() ? 0 : -2;
}

}  // extern "C"
