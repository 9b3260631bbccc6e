"""Static checks of the port against the card: the serving sites of each
kernel and whether a launch configuration fits a Hopper block."""
