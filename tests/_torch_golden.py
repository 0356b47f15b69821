"""Record the reference leaves that tier-1 parity tests hold the port to.

Each named test module keeps its costly JAX package runs as REFERENCES,
{case: function returning {part: {keystr path: numpy}}}; this script runs
every one of them (on the non-partitionable threefry stream, through
`_torch_parity.reference_stream`) and writes the module's
tests/data/<module>_golden.npz. The module's `slow` test
`test_golden_is_the_jax_packages_output` holds the file to a fresh run.

    JAX_PLATFORMS=cpu python tests/_torch_golden.py [module ...]

With no module named, every module in MODULES is recorded.
"""

import importlib
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MODULES = ("test_torch_minipg", "test_torch_stream",
           "test_torch_stream_echo", "test_torch_codegen",
           "test_torch_ldfi", "test_torch_campaign", "test_torch_triage")


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(MODULES)
    for p in (HERE, os.path.dirname(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from _torch_parity import golden_path, write_golden
    for name in names:
        mod = importlib.import_module(name)
        cases = {}
        for case, fn in sorted(mod.REFERENCES.items()):
            t0 = time.time()
            cases[case] = fn()
            print(f"{name} {case}: {time.time() - t0:.1f} s", flush=True)
        path = golden_path(name)
        write_golden(path, cases)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
