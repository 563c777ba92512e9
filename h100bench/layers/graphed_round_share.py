"""Round loop: share of the rounds whose body ran as CUDA-graph replays,
the program's ``obs`` counter ``soa_graph_rounds`` over ``soa_rounds``
(each loop runs its round 0 eagerly, then captures)."""


def read(t):
    graphed = t.counters.get("soa_graph_rounds")
    rounds = t.counters.get("soa_rounds")
    if graphed is None or not rounds:
        return None
    return graphed / rounds
