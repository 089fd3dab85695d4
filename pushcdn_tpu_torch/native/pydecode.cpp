// Batch frame -> Message decoder using the CPython API.
//
// The port's own copy of the JAX package's native/pydecode.cpp, built by
// pushcdn_tpu_torch/native/__init__.py into .build/torch_native/ under a
// file name of its own: the slot offsets below are process-global, so the
// two packages' message classes must never share one loaded library.
//
// The fan-out drain's decoded-delivery rate is bound by per-message Python
// work: decode_frames (proto/message.py) spends its time on byte
// indexing, payload slicing, and Broadcast/Direct construction. This
// translation unit does the same work in C — one call per FrameChunk —
// constructing the SAME Python classes (passed in from message.py) via
// tp_alloc + direct slot writes, bypassing the interpreter loop and
// __init__.  Parity note: this accelerates the hot half of the decode path
// that mirrors the reference's per-frame deserialize in its receive loop
// (cdn-broker/src/tasks/broker/handler.rs:240-272); cold kinds and
// malformed frames go through the Python fallback callable so error
// semantics (Error(DESERIALIZE)) are byte-identical.
//
// Loaded via ctypes.PyDLL (GIL held for the whole call). Compiled
// separately from framing.cpp, which is a plain-C-ABI CDLL whose calls
// release the GIL — mixing the two conventions in one library would make
// it too easy to call a Python-API function GIL-free.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

#ifndef Py_T_OBJECT_EX  // pre-3.12 spelling
#define Py_T_OBJECT_EX T_OBJECT_EX
#include <structmember.h>
#endif

namespace {

constexpr uint8_t KIND_DIRECT = 4;
constexpr uint8_t KIND_BROADCAST = 5;

// Resolved once per process (the message classes are module-level
// singletons); offset 0 means "not resolved / unusable".
struct SlotOffsets {
  Py_ssize_t bc_topics = 0, bc_message = 0;
  Py_ssize_t di_recipient = 0, di_message = 0;
  PyTypeObject* bc_type = nullptr;
  PyTypeObject* di_type = nullptr;
  bool ready = false;
};
SlotOffsets g_slots;

// Find the byte offset of a __slots__ member descriptor on `type`.
// Returns 0 on any surprise (caller then refuses the fast path).
Py_ssize_t slot_offset(PyTypeObject* type, const char* name) {
  PyObject* descr = PyDict_GetItemString(type->tp_dict, name);  // borrowed
  if (descr == nullptr) return 0;
  if (Py_TYPE(descr) != &PyMemberDescr_Type) return 0;
  PyMemberDef* m = ((PyMemberDescrObject*)descr)->d_member;
  if (m == nullptr || m->type != Py_T_OBJECT_EX || m->offset <= 0) return 0;
  return m->offset;
}

bool resolve_types(PyObject* broadcast_type, PyObject* direct_type) {
  if (!PyType_Check(broadcast_type) || !PyType_Check(direct_type))
    return false;
  PyTypeObject* bt = (PyTypeObject*)broadcast_type;
  PyTypeObject* dt = (PyTypeObject*)direct_type;
  SlotOffsets s;
  s.bc_topics = slot_offset(bt, "topics");
  s.bc_message = slot_offset(bt, "message");
  s.di_recipient = slot_offset(dt, "recipient");
  s.di_message = slot_offset(dt, "message");
  if (!s.bc_topics || !s.bc_message || !s.di_recipient || !s.di_message)
    return false;
  // the types outlive the process (module globals); borrow, no incref
  s.bc_type = bt;
  s.di_type = dt;
  s.ready = true;
  g_slots = s;
  return true;
}

// a and b are STOLEN on success; freed on failure.
PyObject* alloc_with_slots(PyTypeObject* type, Py_ssize_t off_a,
                           PyObject* a, Py_ssize_t off_b, PyObject* b) {
  PyObject* obj = type->tp_alloc(type, 0);
  if (obj == nullptr) {
    Py_DECREF(a);
    Py_DECREF(b);
    return nullptr;
  }
  *(PyObject**)((char*)obj + off_a) = a;
  *(PyObject**)((char*)obj + off_b) = b;
  return obj;
}

// A zero-copy payload: a slice of `master` (a memoryview over the chunk
// buffer — the buffer stays alive through the view's reference chain).
// Returns a new reference, or NULL with an exception set.
PyObject* slice_view(PyObject* master, Py_ssize_t start, Py_ssize_t stop) {
  PyObject* lo = PyLong_FromSsize_t(start);
  PyObject* hi = PyLong_FromSsize_t(stop);
  if (lo == nullptr || hi == nullptr) {
    Py_XDECREF(lo);
    Py_XDECREF(hi);
    return nullptr;
  }
  PyObject* sl = PySlice_New(lo, hi, nullptr);
  Py_DECREF(lo);
  Py_DECREF(hi);
  if (sl == nullptr) return nullptr;
  PyObject* out = PyObject_GetItem(master, sl);
  Py_DECREF(sl);
  return out;
}

// Decode one frame at data[o : o+n]. Returns a new message object, or
// NULL with an exception set. With `master` non-NULL (a memoryview of
// the whole buffer), hot payloads of at least `zc_min` bytes come back
// as zero-copy views; smaller ones stay owned copies (message.py
// ZERO_COPY_MIN rationale: the copy is cheaper than the view object AND
// a retained view pins its whole chunk after the permit returns).
PyObject* decode_one(const uint8_t* data, Py_ssize_t o, Py_ssize_t n,
                     PyObject* fallback, PyObject* master,
                     Py_ssize_t zc_min) {
  if (n >= 3) {
    const uint8_t kind = data[o];
    if (kind == KIND_BROADCAST) {
      const Py_ssize_t nt =
          (Py_ssize_t)data[o + 1] | ((Py_ssize_t)data[o + 2] << 8);
      if (3 + nt <= n) {
        PyObject* topics = PyTuple_New(nt);
        if (topics == nullptr) return nullptr;
        for (Py_ssize_t t = 0; t < nt; t++)
          PyTuple_SET_ITEM(topics, t, PyLong_FromLong(data[o + 3 + t]));
        PyObject* msg =
            master != nullptr && n - 3 - nt >= zc_min
                ? slice_view(master, o + 3 + nt, o + n)
                : PyBytes_FromStringAndSize((const char*)data + o + 3 + nt,
                                            n - 3 - nt);
        if (msg == nullptr) {
          Py_DECREF(topics);
          return nullptr;
        }
        return alloc_with_slots(g_slots.bc_type, g_slots.bc_topics, topics,
                                g_slots.bc_message, msg);
      }
    } else if (kind == KIND_DIRECT && n >= 5) {
      const Py_ssize_t rlen = (Py_ssize_t)data[o + 1] |
                              ((Py_ssize_t)data[o + 2] << 8) |
                              ((Py_ssize_t)data[o + 3] << 16) |
                              ((Py_ssize_t)data[o + 4] << 24);
      if (5 + rlen <= n) {
        // the recipient stays an owned bytes copy: it is small and used
        // as a dict key (hashable) by every consumer
        PyObject* rcpt =
            PyBytes_FromStringAndSize((const char*)data + o + 5, rlen);
        if (rcpt == nullptr) return nullptr;
        PyObject* msg =
            master != nullptr && n - 5 - rlen >= zc_min
                ? slice_view(master, o + 5 + rlen, o + n)
                : PyBytes_FromStringAndSize((const char*)data + o + 5 + rlen,
                                            n - 5 - rlen);
        if (msg == nullptr) {
          Py_DECREF(rcpt);
          return nullptr;
        }
        return alloc_with_slots(g_slots.di_type, g_slots.di_recipient, rcpt,
                                g_slots.di_message, msg);
      }
    }
  }
  // cold kind or malformed hot frame: Python fallback keeps the
  // Error(DESERIALIZE) semantics (and may raise — propagate)
  PyObject* frame = PyBytes_FromStringAndSize((const char*)data + o, n);
  if (frame == nullptr) return nullptr;
  PyObject* item = PyObject_CallFunctionObjArgs(fallback, frame, nullptr);
  Py_DECREF(frame);
  return item;
}

}  // namespace

extern "C" {

// Decode frames [start, len(offs)) of one chunk into a list of message
// objects. With zero_copy_min > 0, Broadcast/Direct payloads of at least
// that many bytes are memoryview slices over `buf` (one master view per
// call; the buffer lives as long as any view). Returns:
//   - new list on success;
//   - Py_None (new ref) when inputs don't fit the fast path (caller falls
//     back to the Python decoder);
//   - NULL with an exception set when decoding failed.
PyObject* pushcdn_decode_frames_py(PyObject* buf, PyObject* offs,
                                   PyObject* lens, Py_ssize_t start,
                                   PyObject* broadcast_type,
                                   PyObject* direct_type,
                                   PyObject* fallback,
                                   Py_ssize_t zero_copy_min) {
  // (re)resolve when first called OR when the caller's classes changed
  // (module reload): constructing stale types would silently break
  // type() checks downstream, and a GC'd old type would dangle.
  if ((!g_slots.ready ||
       (PyObject*)g_slots.bc_type != broadcast_type ||
       (PyObject*)g_slots.di_type != direct_type) &&
      !resolve_types(broadcast_type, direct_type))
    Py_RETURN_NONE;
  if (!PyBytes_Check(buf) || !PyList_Check(offs) || !PyList_Check(lens))
    Py_RETURN_NONE;
  const uint8_t* data = (const uint8_t*)PyBytes_AS_STRING(buf);
  const Py_ssize_t buf_len = PyBytes_GET_SIZE(buf);
  const Py_ssize_t count = PyList_GET_SIZE(offs);
  if (PyList_GET_SIZE(lens) != count || start < 0 || start > count)
    Py_RETURN_NONE;

  PyObject* master = nullptr;
  if (zero_copy_min > 0) {
    master = PyMemoryView_FromObject(buf);
    if (master == nullptr) return nullptr;
  }
  PyObject* out = PyList_New(count - start);
  if (out == nullptr) {
    Py_XDECREF(master);
    return nullptr;
  }

  for (Py_ssize_t i = start; i < count; i++) {
    const Py_ssize_t o = PyLong_AsSsize_t(PyList_GET_ITEM(offs, i));
    const Py_ssize_t n = PyLong_AsSsize_t(PyList_GET_ITEM(lens, i));
    if (o < 0 || n < 0 || o + n > buf_len) {
      // non-int or out-of-range offs/lens: delegate the WHOLE batch to
      // the Python loop so both implementations behave identically on
      // degenerate inputs (Python slicing truncates; we must not invent
      // a third behavior here)
      PyErr_Clear();
      Py_DECREF(out);
      Py_XDECREF(master);
      Py_RETURN_NONE;
    }
    PyObject* item = decode_one(data, o, n, fallback, master,
                                zero_copy_min);
    if (item == nullptr) {
      Py_DECREF(out);
      Py_XDECREF(master);
      return nullptr;
    }
    PyList_SET_ITEM(out, i - start, item);
  }
  Py_XDECREF(master);
  return out;
}

}  // extern "C"
