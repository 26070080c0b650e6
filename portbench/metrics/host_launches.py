"""host_launches: the port's kernel launches issued from the host a traced
request, as the program counts them ("launches.host"): each launch of its
kernels, and a CUDA-graph replay as one launch whatever it recorded."""

from portbench.drivers.program import per_request


def read(s: dict):
    return per_request(s, "launches.host")
