"""setup_s: seconds from the process's start to the first measured operation:
imports, CUDA start, the kernel's build or load, the seeded data and its
encode, and the warm-up of every distinct operation."""


def read(r):
    return r.setup_s
