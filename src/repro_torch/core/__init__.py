"""The PE hypercube, its communicator and the flow planner."""
