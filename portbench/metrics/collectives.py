"""collectives: the collectives the port's mesh runs a traced request, as
the program counts them: halo exchanges ("mesh.halo"), all-reduces
("mesh.reduce"), all-gathers ("mesh.gather") and agreed flags
("mesh.any"), on the busiest rank of a cell on several cards; 0.0 on one
card, where the program has no mesh."""

from portbench.drivers.program import per_request

NAMES = ("mesh.halo", "mesh.reduce", "mesh.gather", "mesh.any")


def read(s: dict):
    counts = [per_request(s, name) for name in NAMES]
    if None in counts:
        return None
    return sum(counts)
