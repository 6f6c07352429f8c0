// cozo_c — C ABI host for cozo_tpu_torch (the port's copy of
// `native/cozo_c.cpp`; analog of the reference's cozo-lib-c,
// `cozo-lib-c/src/lib.rs:44-323`): id-indexed handle registry, JSON
// strings in/out, caller frees results with cozo_free_str.  The core
// engine is the cozo_tpu_torch Python package; this library embeds
// CPython and forwards through the string-only shim
// `cozo_tpu_torch.hosts.c_bridge` (no object marshalling crosses the
// ABI).  cozo_open_db's options are JSON: "" or "{}" opens the Db on the
// card, {"device": "cpu"} on the host.
//
// Build: `cozo_tpu_torch.hosts.c_bridge.build_library()`, which runs
//   g++ -O2 -std=c++17 -shared -fPIC -I<include> -o libcozo_c.so \
//       cozo_c.cpp -L$LIBDIR -lpython3.X
// A host runs with the checkout and the interpreter's site-packages on
// PYTHONPATH (`c_bridge.host_env`).
//
// Header surface (mirrors cozo_c.h from the reference):
//   char* cozo_open_db(const char* engine, const char* path,
//                      const char* options, int32_t* db_id);
//   bool  cozo_close_db(int32_t id);
//   char* cozo_run_query(int32_t id, const char* script,
//                        const char* params_json, bool immutable);
//   char* cozo_import_relations(int32_t id, const char* json_payload);
//   char* cozo_export_relations(int32_t id, const char* json_payload);
//   char* cozo_backup(int32_t id, const char* out_path);
//   char* cozo_restore(int32_t id, const char* in_path);
//   char* cozo_import_from_backup(int32_t id, const char* json_payload);
//   void  cozo_free_str(char* s);

#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::once_flag g_init;
PyObject* g_bridge = nullptr;

void init_python() {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    g_bridge = PyImport_ImportModule("cozo_tpu_torch.hosts.c_bridge");
    if (!g_bridge) PyErr_Print();
    PyGILState_Release(gil);
#if PY_VERSION_HEX < 0x030c0000
    // older CPython: release the GIL acquired by Py_Initialize
#endif
}

char* dup_cstr(const std::string& s) {
    char* out = static_cast<char*>(malloc(s.size() + 1));
    memcpy(out, s.data(), s.size());
    out[s.size()] = '\0';
    return out;
}

char* err_json(const char* msg) {
    std::string s = std::string("{\"ok\":false,\"message\":\"") + msg + "\"}";
    return dup_cstr(s);
}

// call bridge.<fn>(args...) -> malloc'd utf-8 of the returned str
char* call_str(const char* fn, PyObject* args) {
    std::call_once(g_init, init_python);
    if (!g_bridge) {
        Py_XDECREF(args);
        return err_json("cozo_tpu_torch python core failed to import");
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    char* out = nullptr;
    PyObject* f = PyObject_GetAttrString(g_bridge, fn);
    if (f && args) {
        PyObject* res = PyObject_CallObject(f, args);
        if (res) {
            const char* u = PyUnicode_AsUTF8(res);
            out = dup_cstr(u ? u : "{\"ok\":false,\"message\":\"non-str\"}");
            Py_DECREF(res);
        } else {
            PyErr_Print();
            out = err_json("python call failed");
        }
    } else {
        out = err_json("bridge function missing");
    }
    Py_XDECREF(f);
    Py_XDECREF(args);
    PyGILState_Release(gil);
    return out;
}

}  // namespace

extern "C" {

char* cozo_open_db(const char* engine, const char* path, const char* options,
                   int32_t* db_id) {
    std::call_once(g_init, init_python);
    if (!g_bridge) return err_json("cozo_tpu_torch python core failed to import");
    PyGILState_STATE gil = PyGILState_Ensure();
    char* err = nullptr;
    PyObject* res = PyObject_CallMethod(
        g_bridge, "open_db", "sss", engine ? engine : "mem",
        path ? path : "", options ? options : "");
    if (!res) {
        PyErr_Print();
        err = err_json("open failed");
    } else {
        const char* u = PyUnicode_AsUTF8(res);
        // parse {"ok": ..., "id": N} minimally
        std::string s = u ? u : "";
        auto pos = s.find("\"id\":");
        if (pos != std::string::npos) {
            *db_id = (int32_t)atoi(s.c_str() + pos + 5);
            err = nullptr;  // success: reference returns NULL
        } else {
            err = dup_cstr(s);
        }
        Py_DECREF(res);
    }
    PyGILState_Release(gil);
    return err;
}

bool cozo_close_db(int32_t id) {
    std::call_once(g_init, init_python);
    if (!g_bridge) return false;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* res = PyObject_CallMethod(g_bridge, "close_db", "i", id);
    bool ok = res && PyObject_IsTrue(res);
    Py_XDECREF(res);
    if (!res) PyErr_Clear();
    PyGILState_Release(gil);
    return ok;
}

char* cozo_run_query(int32_t id, const char* script, const char* params_json,
                     bool immutable) {
    return call_str(
        "run_query",
        Py_BuildValue("(issi)", id, script ? script : "",
                      params_json ? params_json : "{}", immutable ? 1 : 0));
}

char* cozo_import_relations(int32_t id, const char* payload) {
    return call_str("import_relations",
                    Py_BuildValue("(is)", id, payload ? payload : "{}"));
}

char* cozo_export_relations(int32_t id, const char* payload) {
    return call_str("export_relations",
                    Py_BuildValue("(is)", id, payload ? payload : "{}"));
}

char* cozo_backup(int32_t id, const char* out_path) {
    return call_str("backup",
                    Py_BuildValue("(is)", id, out_path ? out_path : ""));
}

char* cozo_restore(int32_t id, const char* in_path) {
    return call_str("restore",
                    Py_BuildValue("(is)", id, in_path ? in_path : ""));
}

char* cozo_import_from_backup(int32_t id, const char* payload) {
    return call_str("import_from_backup",
                    Py_BuildValue("(is)", id, payload ? payload : "{}"));
}

void cozo_free_str(char* s) { free(s); }

}  // extern "C"
