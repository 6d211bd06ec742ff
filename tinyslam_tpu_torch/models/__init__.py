"""Map state, the bootstrap, and the device-resident tracker."""
