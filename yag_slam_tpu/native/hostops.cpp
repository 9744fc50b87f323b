// Native host-side runtime ops.
//
// The accelerator owns the compute path (grid build / lattice search / SPA
// run as XLA programs); what remains on the host per scan is preprocessing
// that the reference does in C++/numba (beam projection + compaction,
// validation-run segmentation: /root/reference/yag_slam/helpers.py:58-68,
// 298-329) and dataset parsing (the reference's loader is a `pass` stub,
// helpers.py:607-610).  These are the per-scan host hot loops; this module
// implements them as a CPython extension so the host never bottlenecks the
// device pipeline.  yag_slam_tpu falls back to the pure-numpy versions when
// the extension is not built (see yag_slam_tpu/native/__init__.py).
//
// Interface style: buffer-protocol in, bytes out (zero-copy on the numpy
// side via np.frombuffer).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// compact_beams: filter (NaN / > threshold) and project to local x/y,
// compacted to the front of cap-sized arrays.
// ---------------------------------------------------------------------------
PyObject* compact_beams(PyObject*, PyObject* args) {
  Py_buffer ranges;
  double min_angle, inc, threshold;
  Py_ssize_t cap;
  if (!PyArg_ParseTuple(args, "y*dddn", &ranges, &min_angle, &inc, &threshold,
                        &cap)) {
    return nullptr;
  }
  const double* r = static_cast<const double*>(ranges.buf);
  const Py_ssize_t n = ranges.len / static_cast<Py_ssize_t>(sizeof(double));

  std::vector<double> xs(cap, 0.0), ys(cap, 0.0);
  Py_ssize_t k = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    const double ri = r[i];
    if (std::isnan(ri) || ri > threshold) continue;
    if (k >= cap) {
      PyBuffer_Release(&ranges);
      PyErr_SetString(PyExc_ValueError, "point capacity exceeded");
      return nullptr;
    }
    const double a = min_angle + static_cast<double>(i) * inc;
    xs[k] = ri * std::cos(a);
    ys[k] = ri * std::sin(a);
    ++k;
  }
  PyBuffer_Release(&ranges);

  PyObject* xs_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(xs.data()), cap * sizeof(double));
  PyObject* ys_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(ys.data()), cap * sizeof(double));
  PyObject* out = Py_BuildValue("(NNn)", xs_b, ys_b, k);
  return out;
}

// ---------------------------------------------------------------------------
// segment_runs: the pose-independent half of the reference's
// validate_points — group points into runs broken at >0.2 m jumps from the
// run anchor; per point emit (anchor idx, terminal idx, has_run).
// ---------------------------------------------------------------------------
PyObject* segment_runs(PyObject*, PyObject* args) {
  Py_buffer pxb, pyb;
  Py_ssize_t n;
  if (!PyArg_ParseTuple(args, "y*y*n", &pxb, &pyb, &n)) return nullptr;
  const double* px = static_cast<const double*>(pxb.buf);
  const double* py = static_cast<const double*>(pyb.buf);

  std::vector<int32_t> anchor(n, 0), term(n, 0);
  std::vector<uint8_t> has(n, 0);
  if (n >= 2) {
    const double msd = 0.2 * 0.2;
    Py_ssize_t fp = 0;
    Py_ssize_t run_start = 1;
    for (Py_ssize_t i = 1; i < n; ++i) {
      const double dx = px[fp] - px[i];
      const double dy = py[fp] - py[i];
      if (dx * dx + dy * dy > msd) {
        for (Py_ssize_t j = run_start; j <= i; ++j) {
          anchor[j] = static_cast<int32_t>(fp);
          term[j] = static_cast<int32_t>(i);
          has[j] = 1;
        }
        fp = i;
        run_start = i + 1;
      }
    }
  }
  PyBuffer_Release(&pxb);
  PyBuffer_Release(&pyb);

  PyObject* a_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(anchor.data()), n * sizeof(int32_t));
  PyObject* t_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(term.data()), n * sizeof(int32_t));
  PyObject* h_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(has.data()), n * sizeof(uint8_t));
  return Py_BuildValue("(NNN)", a_b, t_b, h_b);
}

// ---------------------------------------------------------------------------
// parse_carmen: fast CARMEN log reader (FLASER + ROBOTLASER1 lines).
// Returns a list of tuples:
//   (ranges_bytes_f64, n, min_angle, max_angle, inc, max_range,
//    x, y, theta, timestamp)
// ---------------------------------------------------------------------------
bool parse_doubles(char*& p, double* out, Py_ssize_t count) {
  for (Py_ssize_t i = 0; i < count; ++i) {
    char* end = nullptr;
    out[i] = std::strtod(p, &end);
    if (end == p) return false;
    p = end;
  }
  return true;
}

PyObject* parse_carmen(PyObject*, PyObject* args) {
  const char* path;
  Py_ssize_t max_scans = -1;
  if (!PyArg_ParseTuple(args, "s|n", &path, &max_scans)) return nullptr;

  FILE* f = std::fopen(path, "r");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  PyObject* out = PyList_New(0);
  std::string line;
  std::vector<char> buf(1 << 20);
  std::vector<double> ranges;
  while (std::fgets(buf.data(), static_cast<int>(buf.size()), f)) {
    char* p = buf.data();
    double min_angle, max_angle, inc, max_range, x, y, th, ts = 0.0;
    Py_ssize_t n = 0;
    if (std::strncmp(p, "FLASER ", 7) == 0) {
      p += 7;
      char* end = nullptr;
      n = std::strtol(p, &end, 10);
      if (end == p || n <= 0) continue;
      p = end;
      ranges.resize(n);
      if (!parse_doubles(p, ranges.data(), n)) continue;
      double pose[6];
      if (!parse_doubles(p, pose, 6)) continue;
      x = pose[0];
      y = pose[1];
      th = pose[2];
      double rest[1];
      if (parse_doubles(p, rest, 1)) ts = rest[0];
      const double fov = M_PI;
      inc = fov / static_cast<double>(n);
      min_angle = -fov / 2.0;
      max_angle = fov / 2.0 - inc;
      max_range = 81.9;
    } else if (std::strncmp(p, "ROBOTLASER1 ", 12) == 0) {
      p += 12;
      double head[6];
      if (!parse_doubles(p, head, 6)) continue;  // type start fov res max acc
      char* end = nullptr;
      long rem_mode = std::strtol(p, &end, 10);
      (void)rem_mode;
      if (end == p) continue;
      p = end;
      n = std::strtol(p, &end, 10);
      if (end == p || n <= 0) continue;
      p = end;
      ranges.resize(n);
      if (!parse_doubles(p, ranges.data(), n)) continue;
      long n_rem = std::strtol(p, &end, 10);
      if (end == p) continue;
      p = end;
      if (n_rem > 0) {
        std::vector<double> rem(n_rem);
        if (!parse_doubles(p, rem.data(), n_rem)) continue;
      }
      double pose[6];
      if (!parse_doubles(p, pose, 6)) continue;  // laser xyth + robot xyth
      x = pose[0];
      y = pose[1];
      th = pose[2];
      // CARMEN v2 tail: laser_tv laser_rv forward_safety side_safety
      // turn_axis timestamp (then hostname + logger ts)
      double tail[6];
      if (parse_doubles(p, tail, 6)) ts = tail[5];
      min_angle = head[1];
      inc = head[3];
      max_angle = head[1] + head[2] - inc;
      max_range = head[4];
    } else {
      continue;
    }

    PyObject* rb = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(ranges.data()), n * sizeof(double));
    PyObject* tup = Py_BuildValue("(Nndddddddd)", rb, n, min_angle, max_angle,
                                  inc, max_range, x, y, th, ts);
    PyList_Append(out, tup);
    Py_DECREF(tup);
    if (max_scans > 0 && PyList_Size(out) >= max_scans) break;
  }
  std::fclose(f);
  return out;
}

PyMethodDef methods[] = {
    {"compact_beams", compact_beams, METH_VARARGS,
     "filter+project+compact beam ranges"},
    {"segment_runs", segment_runs, METH_VARARGS,
     "validation-run segmentation"},
    {"parse_carmen", parse_carmen, METH_VARARGS, "parse a CARMEN log file"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_hostops",
    "native host runtime ops for yag_slam_tpu", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__hostops(void) { return PyModule_Create(&module); }
