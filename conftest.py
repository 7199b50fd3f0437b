"""Build the JAX package's host library once, before any test worker starts.

``kmer_spans_tpu/utils/native.py`` builds ``native/libkmerspans_native.so``
at its first load with ``make``, which writes the file in place, and it
remembers a failed load for the rest of the process.  Under pytest-xdist
several workers load it at once: one that finds a half-written file keeps
no library, and its tests of that library fail.  ``pytest_configure`` runs
in the controlling process before xdist starts its workers, so building
there leaves every worker a whole file to load.  Where ``make`` or the
compiler is missing or fails, nothing is built here, and the package
takes its numpy paths as it does without the library.
"""

import subprocess
from pathlib import Path

_NATIVE = Path(__file__).resolve().parent / "native"


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the build is done
        return
    try:
        subprocess.run(["make", "-C", str(_NATIVE), "-s"], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        pass
