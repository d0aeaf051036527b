"""The flags that embed this Python interpreter in a C++ library or
program, from ``sysconfig``; the standard library alone.

``_build.capi_library`` and ``_build.native_program`` link with them, and
``native/CMakeLists.txt`` reads the same ones by running this file::

    python3 backscrub_tpu_torch/_embed.py OUT.cmake

which writes ``set()`` commands for ``BS_EMBED_INCLUDE``,
``BS_EMBED_SHIM`` and ``BS_EMBED_PROGRAM`` (CMake lists) to OUT.cmake.
"""

from __future__ import annotations

import os
import sys
import sysconfig


def python_embed() -> dict:
    """The flags that embed this interpreter:
    ``include`` (compile), ``shim`` (the shared library's link: the shared
    ``libpython`` with an rpath where the interpreter is itself that
    library, else nothing, so that a shim loaded into a statically linked
    interpreter takes that interpreter's symbols and carries no second
    one) and ``program`` (an executable's link: the shared ``libpython``
    with an rpath, or the static archive in ``LIBPL`` whole, with its
    symbols exported for the interpreter's extension modules)."""
    cfg = sysconfig.get_config_var
    inc = (f"-I{cfg('INCLUDEPY')}",)
    if cfg("Py_ENABLE_SHARED"):
        libdir = cfg("LIBDIR")
        lib = (os.path.join(libdir, cfg("LDLIBRARY")), f"-Wl,-rpath,{libdir}")
        return dict(include=inc, shim=lib, program=lib)
    archive = os.path.join(cfg("LIBPL"), cfg("LIBRARY"))
    libs = tuple(f"{cfg('LIBS') or ''} {cfg('SYSLIBS') or ''}".split())
    return dict(include=inc, shim=(), program=("-Wl,--export-dynamic", "-Wl,--whole-archive",
                                               archive, "-Wl,--no-whole-archive", *libs))


def cmake_text(emb: dict) -> str:
    """``emb`` as CMake ``set()`` commands, one list a key."""
    def lst(items):
        return ";".join(str(i).replace("\\", "/").replace('"', '\\"') for i in items)
    return "".join(f'set(BS_EMBED_{k.upper()} "{lst(v)}")\n' for k, v in emb.items())


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(f"usage: {sys.argv[0]} OUT.cmake")
    with open(sys.argv[1], "w") as fh:
        fh.write(cmake_text(python_embed()))
