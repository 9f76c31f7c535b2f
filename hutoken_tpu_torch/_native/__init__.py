"""Holds the compiled native host engine (libhutoken_host.so) when the
package was built with a C++ toolchain (see setup.py).  Loaded via
ctypes by hutoken_tpu_torch.native.load_native(); a checkout without it
loads the shared build in native/."""
