"""Datapath: the batched IPv4 flow pipeline (reference: bpf/ +
pkg/datapath)."""
