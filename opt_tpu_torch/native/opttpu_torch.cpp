/* libopttpu_torch — the C API of native/include/OptTpu.h over the
 * opt_tpu_torch package, through an embedded CPython.
 *
 * Architectural mirror of the reference's createwrapper.t: the reference
 * embeds a LuaJIT/Terra VM inside libOpt.a and exposes C functions that call
 * Lua-held function pointers (createwrapper.t:124-211). Here the embedded VM
 * is CPython and the dispatch target is opt_tpu_torch.native_bridge, which
 * owns object handles (small integers) and does zero-copy pointer
 * marshaling. A client compiled against OptTpu.h links against this
 * library unchanged. It exports the same symbols as the JAX package's
 * libopttpu: never load both into one process.
 *
 * The interpreter is never finalized (as in the JAX package's library): at
 * exit torch may still hold a CUDA context, and tearing the interpreter
 * down under it is not safe. The process's own exit releases both.
 */

#include "OptTpu.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::string g_last_error;
PyObject* g_bridge = nullptr;  // opt_tpu_torch.native_bridge module
std::once_flag g_init_once;

void set_error_from_python() {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    PyObject* s = value ? PyObject_Str(value) : nullptr;
    g_last_error = s ? PyUnicode_AsUTF8(s) : "unknown python error";
    fprintf(stderr, "OptTpu error: %s\n", g_last_error.c_str());
    Py_XDECREF(s);
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

bool ensure_python() {
    std::call_once(g_init_once, []() {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);  // no signal handlers: host app owns signals
        }
        PyGILState_STATE gil = PyGILState_Ensure();
        g_bridge = PyImport_ImportModule("opt_tpu_torch.native_bridge");
        if (!g_bridge) set_error_from_python();
        PyGILState_Release(gil);
    });
    return g_bridge != nullptr;
}

// Call bridge.<fn>(args...) returning a new reference (or null on error).
PyObject* bridge_call(const char* fn, PyObject* args) {
    PyObject* f = PyObject_GetAttrString(g_bridge, fn);
    if (!f) {
        set_error_from_python();
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject* out = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (!out) set_error_from_python();
    return out;
}

long bridge_call_long(const char* fn, PyObject* args, long fallback = 0) {
    PyObject* out = bridge_call(fn, args);
    if (!out) return fallback;
    long v = PyLong_Check(out) ? PyLong_AsLong(out) : fallback;
    Py_DECREF(out);
    return v;
}

double bridge_call_double(const char* fn, PyObject* args, double fallback) {
    PyObject* out = bridge_call(fn, args);
    if (!out) return fallback;
    double v = PyFloat_Check(out) ? PyFloat_AsDouble(out) : fallback;
    Py_DECREF(out);
    return v;
}

PyObject* ptr_list(void** data, uint32_t n) {
    PyObject* lst = PyList_New(n);
    for (uint32_t i = 0; i < n; ++i) {
        PyList_SetItem(lst, i, PyLong_FromVoidPtr(data[i]));
    }
    return lst;
}

struct Gil {
    PyGILState_STATE s;
    Gil() { s = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(s); }
};

}  // namespace

extern "C" {

const char* Opt_LastError(void) {
    return g_last_error.empty() ? nullptr : g_last_error.c_str();
}

Opt_State* Opt_NewState(Opt_InitializationParameters params) {
    if (!ensure_python()) return nullptr;
    Gil gil;
    long h = bridge_call_long(
        "new_state",
        Py_BuildValue("(iii)", params.doublePrecision, params.verbosityLevel,
                      params.collectPerKernelTimingInfo));
    return reinterpret_cast<Opt_State*>(h);
}

void Opt_FreeState(Opt_State* state) {
    if (!g_bridge) return;
    Gil gil;
    PyObject* out =
        bridge_call("release_state", Py_BuildValue("(l)", (long)(intptr_t)state));
    Py_XDECREF(out);
}

Opt_Problem* Opt_ProblemDefine(Opt_State* state, const char* file,
                               const char* kind) {
    if (!ensure_python()) return nullptr;
    Gil gil;
    long h = bridge_call_long(
        "problem_define",
        Py_BuildValue("(lss)", (long)(intptr_t)state, file, kind));
    return reinterpret_cast<Opt_Problem*>(h);
}

void Opt_ProblemDelete(Opt_State* state, Opt_Problem* problem) {
    Gil gil;
    PyObject* out = bridge_call(
        "problem_delete",
        Py_BuildValue("(ll)", (long)(intptr_t)state, (long)(intptr_t)problem));
    Py_XDECREF(out);
}

Opt_Plan* Opt_ProblemPlan(Opt_State* state, Opt_Problem* problem,
                          const uint32_t* dims, uint32_t numDims) {
    Gil gil;
    long h = bridge_call_long(
        "problem_plan",
        Py_BuildValue("(llli)", (long)(intptr_t)state, (long)(intptr_t)problem,
                      (long)(intptr_t)dims, (int)numDims));
    return reinterpret_cast<Opt_Plan*>(h);
}

void Opt_PlanFree(Opt_State* state, Opt_Plan* plan) {
    (void)state;
    Gil gil;
    PyObject* out =
        bridge_call("plan_free", Py_BuildValue("(l)", (long)(intptr_t)plan));
    Py_XDECREF(out);
}

void Opt_SetSolverParameter(Opt_State* state, Opt_Plan* plan, const char* name,
                            double value) {
    (void)state;
    Gil gil;
    PyObject* out = bridge_call(
        "set_solver_parameter",
        Py_BuildValue("(lsd)", (long)(intptr_t)plan, name, value));
    Py_XDECREF(out);
}

void Opt_ProblemInit(Opt_State* state, Opt_Plan* plan, void** data,
                     uint32_t numData) {
    (void)state;
    Gil gil;
    PyObject* args = PyTuple_New(2);
    PyTuple_SetItem(args, 0, PyLong_FromLong((long)(intptr_t)plan));
    PyTuple_SetItem(args, 1, ptr_list(data, numData));
    PyObject* out = bridge_call("problem_init", args);
    Py_XDECREF(out);
}

int Opt_ProblemStep(Opt_State* state, Opt_Plan* plan) {
    (void)state;
    Gil gil;
    return (int)bridge_call_long("problem_step",
                                 Py_BuildValue("(l)", (long)(intptr_t)plan));
}

void Opt_ProblemSolve(Opt_State* state, Opt_Plan* plan, void** data,
                      uint32_t numData) {
    (void)state;
    Gil gil;
    PyObject* args = PyTuple_New(2);
    PyTuple_SetItem(args, 0, PyLong_FromLong((long)(intptr_t)plan));
    PyTuple_SetItem(args, 1, ptr_list(data, numData));
    PyObject* out = bridge_call("problem_solve", args);
    Py_XDECREF(out);
}

double Opt_ProblemCurrentCost(Opt_State* state, Opt_Plan* plan) {
    (void)state;
    Gil gil;
    return bridge_call_double("current_cost",
                              Py_BuildValue("(l)", (long)(intptr_t)plan), -1.0);
}

}  // extern "C"
