"""``setup_s`` (end to end, host clock): from the process's start to the
end of the warm-up call — loading torch and the port (the first run of a
checkout builds the kernels here), making the inputs, ``setup`` and one
call of the cell's own kind."""


def read(run):
    return run.setup_s
