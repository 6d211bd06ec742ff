"""Map state and the device-resident tracker."""
