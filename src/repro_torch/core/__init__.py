"""MIG partition FSM, memory accounting and restart policies (own copies)."""
