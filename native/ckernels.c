/* Host-native covariance kernels (C, CPython API — no pybind11).
 *
 * Role parity with the reference's only native code (SURVEY.md §3 C7/C8:
 * Cython extensions whose job is fast elementwise evaluation of the
 * kernel and its hyperparameter derivatives over all (i, j) pairs).  On
 * the device XLA fuses that loop; this extension is the *host-side*
 * native path: the CPU oracle the test suite cross-checks against, and
 * the same-code-shape denominator for the CPU baseline
 * (benchmarks/cpu_baseline.py).
 *
 * All functions take C-contiguous float64 numpy arrays and fill
 * preallocated outputs, exactly like the reference's `K(out, x1, x2, ...)`
 * convention.  Expressions mirror docs/math.md; derivations are
 * validated against sympy/jax in tests/test_native.py.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <string.h>

/* ---------- helpers ---------- */

static int get_f64(PyObject *obj, Py_buffer *view, int writable) {
    int flags = PyBUF_C_CONTIGUOUS | PyBUF_FORMAT;
    if (writable) flags |= PyBUF_WRITABLE;
    if (PyObject_GetBuffer(obj, view, flags) != 0) return -1;
    if (view->itemsize != sizeof(double) ||
        (view->format != NULL && strcmp(view->format, "d") != 0)) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_TypeError, "expected float64 arrays");
        return -1;
    }
    return 0;
}

/* ---------- squared exponential: k = h^2 exp(-d^2 / 2w^2) ---------- */

static void se_fill(double *out, const double *x1, const double *x2,
                    Py_ssize_t n, Py_ssize_t m, double h, double w,
                    int order) {
    const double h2 = h * h;
    const double iw2 = 1.0 / (w * w);
    const double iw3 = iw2 / w;
    for (Py_ssize_t i = 0; i < n; i++) {
        for (Py_ssize_t j = 0; j < m; j++) {
            const double d = x1[i] - x2[j];
            const double d2 = d * d;
            const double E = exp(-0.5 * d2 * iw2);
            const Py_ssize_t ij = i * m + j;
            const Py_ssize_t nm = n * m;
            if (order == 0) {
                out[ij] = h2 * E;
            } else if (order == 1) {           /* jacobian: (2, n, m) */
                out[ij] = 2.0 * h * E;                      /* dK/dh */
                out[nm + ij] = h2 * E * d2 * iw2 / w;       /* dK/dw */
            } else {                            /* hessian: (2, 2, n, m) */
                const double hh = 2.0 * E;
                const double hw = 2.0 * h * E * d2 * iw3;
                const double ww =
                    h2 * E * (d2 * d2 * iw3 * iw3 - 3.0 * d2 * iw2 * iw2);
                out[0 * nm + ij] = hh;          /* (h,h) */
                out[1 * nm + ij] = hw;          /* (h,w) */
                out[2 * nm + ij] = hw;          /* (w,h) */
                out[3 * nm + ij] = ww;          /* (w,w) */
            }
        }
    }
}

/* ---------- periodic: k = h^2 exp(-2 sin^2(d/2p) / w^2) ---------- */

static void per_fill(double *out, const double *x1, const double *x2,
                     Py_ssize_t n, Py_ssize_t m, double h, double w,
                     double p, int order) {
    const double h2 = h * h;
    const double iw2 = 1.0 / (w * w);
    const double ip = 1.0 / p;
    for (Py_ssize_t i = 0; i < n; i++) {
        for (Py_ssize_t j = 0; j < m; j++) {
            const double d = x1[i] - x2[j];
            const double u = 0.5 * d * ip;
            const double s = sin(u);
            const double s2u = sin(2.0 * u);
            const double c2u = cos(2.0 * u);
            const double E = exp(-2.0 * s * s * iw2);
            const double g_w = 4.0 * s * s * iw2 / w;
            const double g_p = d * s2u * iw2 * ip * ip;
            const Py_ssize_t ij = i * m + j;
            const Py_ssize_t nm = n * m;
            if (order == 0) {
                out[ij] = h2 * E;
            } else if (order == 1) {            /* jacobian: (3, n, m) */
                out[ij] = 2.0 * h * E;
                out[nm + ij] = h2 * E * g_w;
                out[2 * nm + ij] = h2 * E * g_p;
            } else {                             /* hessian: (3, 3, n, m) */
                const double g_ww = -12.0 * s * s * iw2 * iw2;
                const double g_wp = -2.0 * d * s2u * iw2 / w * ip * ip;
                const double g_pp =
                    -d * (d * c2u * ip + 2.0 * s2u) * iw2 * ip * ip * ip;
                const double k_hh = 2.0 * E;
                const double k_hw = 2.0 * h * E * g_w;
                const double k_hp = 2.0 * h * E * g_p;
                const double k_ww = h2 * E * (g_w * g_w + g_ww);
                const double k_wp = h2 * E * (g_w * g_p + g_wp);
                const double k_pp = h2 * E * (g_p * g_p + g_pp);
                out[0 * nm + ij] = k_hh;  /* (h,h) */
                out[1 * nm + ij] = k_hw;  /* (h,w) */
                out[2 * nm + ij] = k_hp;  /* (h,p) */
                out[3 * nm + ij] = k_hw;  /* (w,h) */
                out[4 * nm + ij] = k_ww;  /* (w,w) */
                out[5 * nm + ij] = k_wp;  /* (w,p) */
                out[6 * nm + ij] = k_hp;  /* (p,h) */
                out[7 * nm + ij] = k_wp;  /* (p,w) */
                out[8 * nm + ij] = k_pp;  /* (p,p) */
            }
        }
    }
}

/* ---------- python wrappers ---------- */

static PyObject *dispatch(PyObject *args, int periodic, int order) {
    PyObject *out_o, *x1_o, *x2_o;
    double h, w, p = 1.0;
    if (periodic) {
        if (!PyArg_ParseTuple(args, "OOOddd", &out_o, &x1_o, &x2_o, &h, &w, &p))
            return NULL;
    } else {
        if (!PyArg_ParseTuple(args, "OOOdd", &out_o, &x1_o, &x2_o, &h, &w))
            return NULL;
    }
    Py_buffer out_b, x1_b, x2_b;
    if (get_f64(out_o, &out_b, 1)) return NULL;
    if (get_f64(x1_o, &x1_b, 0)) { PyBuffer_Release(&out_b); return NULL; }
    if (get_f64(x2_o, &x2_b, 0)) {
        PyBuffer_Release(&out_b); PyBuffer_Release(&x1_b); return NULL;
    }
    Py_ssize_t n = x1_b.len / (Py_ssize_t)sizeof(double);
    Py_ssize_t m = x2_b.len / (Py_ssize_t)sizeof(double);
    int nparam = periodic ? 3 : 2;
    Py_ssize_t expect = n * m;
    if (order == 1) expect *= nparam;
    if (order == 2) expect *= nparam * nparam;
    if (out_b.len != expect * (Py_ssize_t)sizeof(double)) {
        PyBuffer_Release(&out_b); PyBuffer_Release(&x1_b); PyBuffer_Release(&x2_b);
        PyErr_SetString(PyExc_ValueError, "output buffer has wrong size");
        return NULL;
    }
    Py_BEGIN_ALLOW_THREADS
    if (periodic)
        per_fill((double *)out_b.buf, (const double *)x1_b.buf,
                 (const double *)x2_b.buf, n, m, h, w, p, order);
    else
        se_fill((double *)out_b.buf, (const double *)x1_b.buf,
                (const double *)x2_b.buf, n, m, h, w, order);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&out_b); PyBuffer_Release(&x1_b); PyBuffer_Release(&x2_b);
    Py_RETURN_NONE;
}

static PyObject *se_K(PyObject *self, PyObject *a) { return dispatch(a, 0, 0); }
static PyObject *se_jacobian(PyObject *self, PyObject *a) { return dispatch(a, 0, 1); }
static PyObject *se_hessian(PyObject *self, PyObject *a) { return dispatch(a, 0, 2); }
static PyObject *per_K(PyObject *self, PyObject *a) { return dispatch(a, 1, 0); }
static PyObject *per_jacobian(PyObject *self, PyObject *a) { return dispatch(a, 1, 1); }
static PyObject *per_hessian(PyObject *self, PyObject *a) { return dispatch(a, 1, 2); }

static PyMethodDef methods[] = {
    {"se_K", se_K, METH_VARARGS, "se_K(out[n,m], x1, x2, h, w)"},
    {"se_jacobian", se_jacobian, METH_VARARGS, "se_jacobian(out[2,n,m], x1, x2, h, w)"},
    {"se_hessian", se_hessian, METH_VARARGS, "se_hessian(out[2,2,n,m], x1, x2, h, w)"},
    {"periodic_K", per_K, METH_VARARGS, "periodic_K(out[n,m], x1, x2, h, w, p)"},
    {"periodic_jacobian", per_jacobian, METH_VARARGS, "periodic_jacobian(out[3,n,m], x1, x2, h, w, p)"},
    {"periodic_hessian", per_hessian, METH_VARARGS, "periodic_hessian(out[3,3,n,m], x1, x2, h, w, p)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ckernels",
    "host-native covariance kernel evaluation", -1, methods};

PyMODINIT_FUNC PyInit__ckernels(void) { return PyModule_Create(&moduledef); }
