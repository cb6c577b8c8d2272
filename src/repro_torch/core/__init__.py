"""The paper's dataflow core on torch (§3-4): the graph and its op library,
variables and queues, placement, partitioning with Send/Recv, user-level
autodiff, Switch/Merge control flow, the executor and the client Session.
Every task of a ``Cluster`` runs on the card unless the caller asks for
the host."""
