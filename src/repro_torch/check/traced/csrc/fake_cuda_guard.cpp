// A no-op CUDA device guard for a PyTorch built without CUDA.
//
// The traced layer (repro_torch/check/traced/capture.py) runs the port's
// entry points on fake `cuda` tensors, which allocate nothing.  On a CPU-only
// build the Python bindings of indexing, `copy_` and `.to("cuda")` still ask
// c10 for the CUDA device guard, and the registry has none, so a fake card
// tensor can be made but not sliced.  This library fills that registry slot
// with c10's no-op guard while a capture runs and empties it after; it never
// replaces a guard that a CUDA build registered.  Built with the host
// compiler against torch's headers and libc10, nothing else.
#include <c10/core/impl/DeviceGuardImplInterface.h>

namespace {

c10::impl::NoOpDeviceGuardImpl<c10::DeviceType::CUDA> no_op_guard;

std::atomic<const c10::impl::DeviceGuardImplInterface*>& cuda_slot() {
  return c10::impl::device_guard_impl_registry[static_cast<size_t>(c10::DeviceType::CUDA)];
}

}  // namespace

// 1 if the no-op guard was put in the empty slot, 0 if a guard was there.
extern "C" int fake_cuda_guard_install() {
  const c10::impl::DeviceGuardImplInterface* empty = nullptr;
  return cuda_slot().compare_exchange_strong(empty, &no_op_guard) ? 1 : 0;
}

// Empties the slot if it holds the no-op guard; leaves any other guard.
extern "C" void fake_cuda_guard_remove() {
  const c10::impl::DeviceGuardImplInterface* mine = &no_op_guard;
  cuda_slot().compare_exchange_strong(mine, nullptr);
}
