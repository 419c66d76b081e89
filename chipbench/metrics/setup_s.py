"""Set-up: process start to the first timed request (imports, the weights
made on the device, the prompts drawn, the kernels built or loaded, the
cell's shape warmed up), seconds on the host's clock."""


def read(run):
    return run.setup_s
