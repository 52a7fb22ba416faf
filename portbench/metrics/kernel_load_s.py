"""The set-up's time in the program's kernel loader: the seconds of the one
``ops/kernels/_build.build`` call of the process, the nvcc build of any
source not on disk and the ``ctypes`` load of every library (the program's
counter ``kernels.load_s``)."""

from portbench import spans


def read(trace, run):
    return spans.counter("kernels.load_s")
