"""Native (C++) host backend for tpu_blosc.

The reference accelerates its hot host loops with hand-written assembly
(shuffle_amd64.s / shuffle_arm64.s); our host-side analogue is a small C++
library (tpublosc.cpp) exposing the block codecs and shuffle filters
through ctypes.  ``python -m tpu_blosc.native`` builds it for this host.
"""
