"""MoE core: router and the single-device sparse MoE block."""
