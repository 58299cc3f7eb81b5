"""nn.Modules of the port and the host-side splice planner."""
