"""Compare the SASS of two CUDA sources kernel by kernel, on a machine with nvcc.

A change that should leave a kernel's machine code alone (a primitive moved
into a shared header, a rename) can be checked without timing anything:

    python3 tools/torch_sass_diff.py OLD.cu NEW.cu

Both sources compile with the port's nvcc flags to a cubin, headers found
beside NEW.cu; ``cuobjdump -sass`` lists each kernel's instructions, which are
compared after addresses, encodings and the anonymous namespace's per-file
prefix are stripped. Prints the kernels and their instruction counts, then
``SASS_IDENTICAL`` (exit 0) or ``SASS_DIFFERS`` and the kernels that differ
(exit 1). To hold a source against its parent, unpack the parent with
``git archive`` into a directory that ``.gitignore`` lists.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from diffsensei_tpu_torch.ops import _build  # noqa: E402


def sass(src: Path, include: Path, out: Path) -> dict:
    """{kernel: [instruction, ...]} of ``src`` built for sm_90a."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-I", str(include), "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(out)], check=True,
                          capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__.*?_cu_[0-9a-f]+_\d+", "", m.group(1))
            kernels[name] = []
        elif name is not None:
            line = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
            if line:
                kernels[name].append(line)
    return kernels


def main() -> int:
    old, new = (Path(a).resolve() for a in sys.argv[1:3])
    with tempfile.TemporaryDirectory() as tmp:
        a = sass(old, new.parent, Path(tmp) / "old.cubin")
        b = sass(new, new.parent, Path(tmp) / "new.cubin")
    for name in sorted(set(a) | set(b)):
        print(name, len(a.get(name, [])), len(b.get(name, [])))
    differ = sorted(n for n in set(a) | set(b) if a.get(n) != b.get(n))
    print("SASS_IDENTICAL" if not differ else f"SASS_DIFFERS {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
