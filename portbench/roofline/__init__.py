"""The yardstick of the layer rooflines: the card's peaks and the work a
layer needs, counted from the cell's own rows."""
