#!/usr/bin/env python3
"""graftcheck over the PyTorch/CUDA port — the counterpart of
``tools/graftcheck.py``, importable without torch.

The launcher loads ``mxnet_tpu_torch/analysis/{core,passes}`` as a
standalone package instead of importing ``mxnet_tpu_torch`` (whose
__init__ imports torch), so the lane runs before any dependency install.

    python tools/torch_graftcheck.py            # scan mxnet_tpu_torch/
    python tools/torch_graftcheck.py mxnet_tpu_torch/ --json
    python tools/torch_graftcheck.py --list-rules
    python tools/torch_graftcheck.py --baseline graftcheck-torch-baseline.json
    python tools/torch_graftcheck.py --write-baseline graftcheck-torch-baseline.json
    python tools/torch_graftcheck.py --write-lock-baseline graftcheck-torch-lockorder.json

Exit codes: 0 clean, 1 findings, 2 usage/internal error.
"""

import importlib
import os
import sys
import types

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.join(REPO_ROOT, "mxnet_tpu_torch", "analysis")


def _load_analysis():
    """Load the port's analysis package under a private name so
    ``mxnet_tpu_torch``'s package __init__ (which imports torch) never
    runs."""
    if "mxnet_tpu_torch.analysis" in sys.modules:
        return sys.modules["mxnet_tpu_torch.analysis.core"]
    pkg_name = "_torch_graftcheck_analysis"
    pkg = sys.modules.get(pkg_name)
    if pkg is None:
        pkg = types.ModuleType(pkg_name)
        pkg.__path__ = [_ANALYSIS_DIR]
        sys.modules[pkg_name] = pkg
    importlib.import_module(pkg_name + ".passes")  # registers GC01–GC10
    return importlib.import_module(pkg_name + ".core")


def main(argv=None):
    core = _load_analysis()
    return core.main(argv, repo_root=REPO_ROOT)


if __name__ == "__main__":
    sys.exit(main())
