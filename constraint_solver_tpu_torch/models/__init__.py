"""Problem domains: N-Queens (and PMC), scheduling, QAP, Ackley and diagram layout."""
