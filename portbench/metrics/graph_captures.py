"""graph_captures: the CUDA graphs the port records a traced request, as
the program counts them ("graphs.captures")."""

from portbench.drivers.program import per_request


def read(s: dict):
    return per_request(s, "graphs.captures")
