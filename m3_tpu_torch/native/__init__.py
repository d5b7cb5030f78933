"""Host C++ helpers of the port, bound with ctypes: the native ID->slot
resolver (``idmap``), built with g++ at first use (``_build``).  The
counterpart of ``m3_tpu/native``'s resolver; sources live in
``m3_tpu_torch/csrc``."""
