"""One general loop per kind of traffic (train, eval, serve): each reads
its mix's parameters from ``traffic/<mix>.json``."""
