// The weights check of stream/graphs.py:WeightsVersion in one host call: a
// Python extension type, Snapshot, compiled against torch's headers by the
// host's C++ compiler (ops/_cuda.py builds it beside the kernels). No device
// code.
//
// A CUDA graph bakes in the address of every weight it reads, so before each
// replay the caller asks whether any parameter or buffer was written in place
// (its version counter moved: load_state_dict, a raw p.mul_() under no_grad)
// or moved storage (a cast, `.data =`). Asked in Python, as a tuple of every
// tensor's data_ptr() and _version, that is two Python calls for each of the
// ~1,300 tensors of RVC v2 with ContentVec and RMVPE, all of it before the
// step's first launch. Here it is one loop over the held tensors.
//
//     Snapshot.take(tensors) -> epoch   hold `tensors` (a sequence), note each
//                                       one's data pointer and version, and
//                                       count a new epoch
//     Snapshot.advance() -> epoch       compare every held tensor with its
//                                       note; if any differs, note them anew
//                                       and count a new epoch
//     len(snapshot)                     the tensors held
//
// So two epochs of one Snapshot are equal exactly when no held tensor's data
// pointer or version was seen to change between the calls that returned them.
// The calls hold the GIL throughout: no Python thread runs between a
// comparison and the epoch it returns.

#include <Python.h>
#include <torch/csrc/autograd/python_variable.h>

#include <cstdint>
#include <exception>
#include <new>
#include <vector>

namespace {

// The Python tensor object, not its TensorImpl: torch.utils.swap_tensors gives
// an object another TensorImpl, and the check must follow the object, as
// t.data_ptr() on it does.
struct Held {
    PyObject* tensor;  // a strong reference
    const void* data;
    int64_t version;
};

void release(std::vector<Held>& held) {
    for (Held& h : held) Py_DECREF(h.tensor);
    held.clear();
}

struct Snapshot {
    PyObject_HEAD
    std::vector<Held>* held;
    long long epoch;
};

PyObject* snapshot_new(PyTypeObject* type, PyObject*, PyObject*) {
    auto* self = reinterpret_cast<Snapshot*>(type->tp_alloc(type, 0));
    if (self == nullptr) return nullptr;
    self->held = new (std::nothrow) std::vector<Held>();
    if (self->held == nullptr) {
        Py_DECREF(self);
        return PyErr_NoMemory();
    }
    self->epoch = 0;
    return reinterpret_cast<PyObject*>(self);
}

void snapshot_dealloc(PyObject* obj) {
    auto* self = reinterpret_cast<Snapshot*>(obj);
    release(*self->held);
    delete self->held;
    PyTypeObject* type = Py_TYPE(obj);
    type->tp_free(obj);
    Py_DECREF(type);
}

PyObject* snapshot_take(PyObject* obj, PyObject* tensors) {
    auto* self = reinterpret_cast<Snapshot*>(obj);
    PyObject* seq = PySequence_Fast(tensors, "Snapshot.take takes a sequence of tensors");
    if (seq == nullptr) return nullptr;
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    std::vector<Held> held;
    try {
        held.reserve(static_cast<size_t>(n));
        for (Py_ssize_t i = 0; i < n; ++i) {
            PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
            if (!THPVariable_Check(item)) {
                PyErr_Format(PyExc_TypeError, "Snapshot.take: item %zd is a %s, not a tensor", i,
                             Py_TYPE(item)->tp_name);
                release(held);
                Py_DECREF(seq);
                return nullptr;
            }
            const at::Tensor& t = THPVariable_Unpack(item);
            held.push_back(Held{item, t.const_data_ptr(), t._version()});
            Py_INCREF(item);
        }
    } catch (const std::exception& e) {
        PyErr_SetString(PyExc_RuntimeError, e.what());
        release(held);
        Py_DECREF(seq);
        return nullptr;
    }
    Py_DECREF(seq);
    self->held->swap(held);
    release(held);
    return PyLong_FromLongLong(++self->epoch);
}

PyObject* snapshot_advance(PyObject* obj, PyObject*) {
    auto* self = reinterpret_cast<Snapshot*>(obj);
    bool changed = false;
    try {
        for (Held& h : *self->held) {
            const at::Tensor& t = THPVariable_Unpack(h.tensor);
            const void* data = t.const_data_ptr();
            const int64_t version = t._version();
            if (data != h.data || version != h.version) {
                h.data = data;
                h.version = version;
                changed = true;
            }
        }
    } catch (const std::exception& e) {
        if (changed) ++self->epoch;  // the notes already taken stand for a change
        PyErr_SetString(PyExc_RuntimeError, e.what());
        return nullptr;
    }
    if (changed) ++self->epoch;
    return PyLong_FromLongLong(self->epoch);
}

Py_ssize_t snapshot_len(PyObject* obj) {
    return static_cast<Py_ssize_t>(reinterpret_cast<Snapshot*>(obj)->held->size());
}

PyMethodDef snapshot_methods[] = {
    {"take", snapshot_take, METH_O, "Hold these tensors, note each one's data pointer and version; the new epoch."},
    {"advance", snapshot_advance, METH_NOARGS,
     "Compare the held tensors with their notes; the epoch, counted up once if any changed."},
    {nullptr, nullptr, 0, nullptr},
};

PyType_Slot snapshot_slots[] = {
    {Py_tp_new, reinterpret_cast<void*>(snapshot_new)},
    {Py_tp_dealloc, reinterpret_cast<void*>(snapshot_dealloc)},
    {Py_tp_methods, snapshot_methods},
    {Py_sq_length, reinterpret_cast<void*>(snapshot_len)},
    {Py_tp_doc, const_cast<char*>("The data pointer and version of each of a list of tensors, and an epoch.")},
    {0, nullptr},
};

PyType_Spec snapshot_spec = {
    "weights_snapshot.Snapshot", sizeof(Snapshot), 0, Py_TPFLAGS_DEFAULT, snapshot_slots,
};

PyModuleDef module_def = {
    PyModuleDef_HEAD_INIT, "weights_snapshot", "The weights check of stream/graphs.py in one host call.", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_weights_snapshot() {
    PyObject* module = PyModule_Create(&module_def);
    if (module == nullptr) return nullptr;
    PyObject* type = PyType_FromSpec(&snapshot_spec);
    if (type == nullptr || PyModule_AddObject(module, "Snapshot", type) < 0) {
        Py_XDECREF(type);
        Py_DECREF(module);
        return nullptr;
    }
    return module;
}
