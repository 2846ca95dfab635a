// Native snapshot codec: legacy *binary* VTK structured-points writer.
//
// The serialization loop of the port's snapshot path (io.write_vtk): the
// big-endian conversion and the Fortran-order traversal in native code,
// written with one buffered stream. io.write_vtk_ascii is its plain
// version. Built with g++ at first use and loaded with ctypes by
// navierstokessolver_tpu_torch/native.py; a failed build raises. The same
// source as the JAX package's codec (csrc/snapshot_codec.cpp at the repo
// root), so both packages write the same bytes for the same arrays.
//
// Layout contract: fields arrive as C-order float32 arrays of shape
// (nx, ny[, nz]); VTK wants Fortran order (x fastest) and big-endian floats.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

inline uint32_t to_be(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__)
  u = __builtin_bswap32(u);
#endif
  return u;
}

// Gather a C-order (nx, ny, nz) array into big-endian Fortran order.
void gather_be(const float* src, int nx, int ny, int nz,
               std::vector<uint32_t>& out) {
  out.resize(static_cast<size_t>(nx) * ny * nz);
  size_t idx = 0;
  for (int k = 0; k < nz; ++k)
    for (int j = 0; j < ny; ++j)
      for (int i = 0; i < nx; ++i)
        out[idx++] = to_be(src[(static_cast<size_t>(i) * ny + j) * nz + k]);
}

}  // namespace

extern "C" {

// Writes a legacy binary VTK structured-points file.
//   dims/spacing: 3 entries (set nz=1, dz=1 for 2D)
//   n_vec: number of velocity components provided (2 or 3); missing -> 0
//   vec[c]: pointer to component c, C-order (nx, ny, nz)
//   n_scalars: scalar field count; names as '\n'-joined string
// Returns 0 on success, negative errno-style codes on failure.
int write_vtk_binary(const char* path, const int* dims, const double* spacing,
                     int n_vec, const float* const* vec, int n_scalars,
                     const char* scalar_names, const float* const* scalars,
                     const char* title) {
  const int nx = dims[0], ny = dims[1], nz = dims[2];
  const size_t n = static_cast<size_t>(nx) * ny * nz;
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::setvbuf(f, nullptr, _IOFBF, 1 << 20);

  std::fprintf(f, "# vtk DataFile Version 3.0\n%s\nBINARY\n", title);
  std::fprintf(f, "DATASET STRUCTURED_POINTS\n");
  std::fprintf(f, "DIMENSIONS %d %d %d\n", nx, ny, nz);
  std::fprintf(f, "ORIGIN 0 0 0\n");
  std::fprintf(f, "SPACING %g %g %g\n", spacing[0], spacing[1], spacing[2]);
  std::fprintf(f, "POINT_DATA %zu\n", n);

  std::vector<uint32_t> buf;
  if (n_vec > 0) {
    std::fprintf(f, "VECTORS velocity float\n");
    std::vector<std::vector<uint32_t>> comps(3);
    for (int c = 0; c < 3; ++c) {
      if (c < n_vec) {
        gather_be(vec[c], nx, ny, nz, comps[c]);
      } else {
        comps[c].assign(n, to_be(0.0f));
      }
    }
    std::vector<uint32_t> inter(n * 3);
    for (size_t i = 0; i < n; ++i) {
      inter[3 * i] = comps[0][i];
      inter[3 * i + 1] = comps[1][i];
      inter[3 * i + 2] = comps[2][i];
    }
    if (std::fwrite(inter.data(), 4, inter.size(), f) != inter.size()) {
      std::fclose(f);
      return -2;
    }
    std::fputc('\n', f);
  }

  // scalar fields
  const char* name = scalar_names;
  for (int s = 0; s < n_scalars; ++s) {
    const char* end = std::strchr(name, '\n');
    std::string nm = end ? std::string(name, end - name) : std::string(name);
    name = end ? end + 1 : name + nm.size();
    std::fprintf(f, "SCALARS %s float 1\nLOOKUP_TABLE default\n", nm.c_str());
    gather_be(scalars[s], nx, ny, nz, buf);
    if (std::fwrite(buf.data(), 4, buf.size(), f) != buf.size()) {
      std::fclose(f);
      return -2;
    }
    std::fputc('\n', f);
  }
  if (std::fclose(f) != 0) return -3;
  return 0;
}

}  // extern "C"
