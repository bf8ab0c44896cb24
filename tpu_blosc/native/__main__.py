"""Build the native runtime for this host: ``python -m tpu_blosc.native``.

Builds ``libtpublosc.so`` and ``_tpbfast.so`` from the tracked sources if
this host's build is missing (see backend.py for the build key and the
deadline), prints the build record as one JSON line, and exits 1 when the
library is unavailable.
"""

import json
import sys

from . import backend


def main() -> int:
    ok = backend.available()
    info = backend.build_info()
    info.update(
        available=ok,
        zstd=backend.zstd_available(),
        threads=backend.num_threads(),
    )
    print(json.dumps(info))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
