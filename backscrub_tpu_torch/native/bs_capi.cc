// bs_capi: the libbackscrub C ABI over the PyTorch/CUDA port.
//
// Exports the symbols of native/backscrub.h (bs_tensorflow_version,
// bs_maskgen_new, bs_maskgen_new_ex, bs_maskgen_process, bs_maskgen_delete)
// with the same signatures as native/bs_capi.cc, so a consumer switches back
// ends by linking the other shared object.  It embeds CPython and drives
// backscrub_tpu_torch.pipeline.maskgen.maskgen_for_capi: masks come from the
// card (BACKSCRUB_TORCH_DEVICE=cuda, the default) or, when asked, from the
// CPU (BACKSCRUB_TORCH_DEVICE=cpu).  Without CUDA and without `cpu` asked
// for, construction fails: NULL, with the message on ondebug.
//
// Frames are raw BGR u8 (height*width*3 bytes, row-major); masks raw u8
// (height*width), 0 = person, 255 = background.  This file only marshals
// frames in and masks out; every Python error becomes a NULL or false
// return and an ondebug message.
//
// Build: backscrub_tpu_torch._build.capi_library().

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

#if __has_include("backscrub.h")
#include "backscrub.h"  // checks these definitions against the public header
#endif

namespace {

struct bs_ctx {
  PyObject *maskgen = nullptr;  // backscrub_tpu_torch MaskGen
  PyObject *process = nullptr;  // its bound process_bytes
  size_t width = 0, height = 0;
  void (*ondebug)(void *, const char *) = nullptr;
  void *caller_ctx = nullptr;
};

std::once_flag g_py_once;

void ensure_python() {
  std::call_once(g_py_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // Release the GIL Py_InitializeEx took, so that a caller on any
      // thread can take it with PyGILState_Ensure.
      PyEval_SaveThread();
    }
  });
}

void dbg(const bs_ctx *c, const std::string &msg) {
  if (c->ondebug) c->ondebug(c->caller_ctx, msg.c_str());
}

// The pending Python exception as text (its str()), cleared.
std::string py_error() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  std::string out = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *utf8 = PyUnicode_AsUTF8(s);
      if (utf8) out = utf8;
      else PyErr_Clear();
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return out;
}

// Fail construction: the message on ondebug, the context freed, NULL.
void *fail_new(bs_ctx *c, PyGILState_STATE g) {
  dbg(c, "bs_maskgen_new: " + py_error());
  Py_XDECREF(c->process);
  Py_XDECREF(c->maskgen);
  PyGILState_Release(g);
  delete c;
  return nullptr;
}

}  // namespace

extern "C" {

// The runtime's version, "torch-<version>" (lib/libbackscrub.cc:150 reports
// TensorFlow's; the name is kept for the ABI).
const char *bs_tensorflow_version(void) {
  static char buf[128] = {0};
  static std::once_flag once;
  std::call_once(once, [] {
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *mod = PyImport_ImportModule("torch");
    PyObject *v = mod ? PyObject_GetAttrString(mod, "__version__") : nullptr;
    const char *s = v ? PyUnicode_AsUTF8(v) : nullptr;
    if (s) snprintf(buf, sizeof(buf), "torch-%s", s);
    else {
      PyErr_Clear();
      snprintf(buf, sizeof(buf), "torch-unavailable");
    }
    Py_XDECREF(v);
    Py_XDECREF(mod);
    PyGILState_Release(g);
  });
  return buf;
}

// `options`: comma-separated tokens of the CLI's -p namespace
// ("refine:guided,morph:open:3,u8exact,no-bilateral"), parsed by
// parse_capi_options; an unknown token fails construction.
void *bs_maskgen_new_ex(const char *modelname, size_t threads, size_t width,
                        size_t height, const char *options,
                        void (*ondebug)(void *, const char *),
                        void (*onprep)(void *), void (*oninfer)(void *),
                        void (*onmask)(void *), void *caller_ctx) {
  (void)threads;  // the card's work is PyTorch's; accepted for the ABI
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  bs_ctx *c = new bs_ctx();
  c->width = width;
  c->height = height;
  c->ondebug = ondebug;
  c->caller_ctx = caller_ctx;

  PyObject *mod = PyImport_ImportModule("backscrub_tpu_torch.pipeline.maskgen");
  if (!mod) return fail_new(c, g);
  // maskgen_for_capi wraps the callback pointers as Python callables and
  // picks the staged mode when onprep or oninfer is set, so every stage
  // hook of the reference contract fires from inside the pipeline.
  PyObject *factory = PyObject_GetAttrString(mod, "maskgen_for_capi");
  Py_DECREF(mod);
  if (!factory) return fail_new(c, g);
  c->maskgen = PyObject_CallFunction(
      factory, "sllsKKKKK", modelname ? modelname : "", (long)width,
      (long)height, options ? options : "",
      (unsigned long long)(uintptr_t)ondebug,
      (unsigned long long)(uintptr_t)onprep,
      (unsigned long long)(uintptr_t)oninfer,
      (unsigned long long)(uintptr_t)onmask,
      (unsigned long long)(uintptr_t)caller_ctx);
  Py_DECREF(factory);
  if (!c->maskgen) return fail_new(c, g);
  c->process = PyObject_GetAttrString(c->maskgen, "process_bytes");
  if (!c->process) return fail_new(c, g);
  PyGILState_Release(g);
  return c;
}

// The reference constructor (lib/libbackscrub.h:31-39): no options.
void *bs_maskgen_new(const char *modelname, size_t threads, size_t width,
                     size_t height, void (*ondebug)(void *, const char *),
                     void (*onprep)(void *), void (*oninfer)(void *),
                     void (*onmask)(void *), void *caller_ctx) {
  return bs_maskgen_new_ex(modelname, threads, width, height, "", ondebug,
                           onprep, oninfer, onmask, caller_ctx);
}

void bs_maskgen_delete(void *context) {
  if (!context) return;
  bs_ctx *c = (bs_ctx *)context;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_XDECREF(c->process);
  Py_XDECREF(c->maskgen);
  PyGILState_Release(g);
  delete c;
}

// frame: height*width*3 BGR u8; mask out: height*width u8.
bool bs_maskgen_process(void *context, const uint8_t *frame, uint8_t *mask) {
  if (!context || !frame || !mask) return false;
  bs_ctx *c = (bs_ctx *)context;
  const size_t npx = c->width * c->height;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *bytes =
      PyBytes_FromStringAndSize((const char *)frame, (Py_ssize_t)(npx * 3));
  PyObject *res = bytes ? PyObject_CallFunction(c->process, "Oll", bytes,
                                                (long)c->height, (long)c->width)
                        : nullptr;
  Py_XDECREF(bytes);
  if (!res) {
    dbg(c, "bs_maskgen_process: " + py_error());
    PyGILState_Release(g);
    return false;
  }
  char *buf = nullptr;
  Py_ssize_t len = 0;
  bool ok = PyBytes_AsStringAndSize(res, &buf, &len) == 0 && (size_t)len == npx;
  if (ok) std::memcpy(mask, buf, npx);
  else PyErr_Clear();
  Py_DECREF(res);
  if (!ok) dbg(c, "bs_maskgen_process: bad mask payload");
  PyGILState_Release(g);
  return ok;
}

}  // extern "C"
