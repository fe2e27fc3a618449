"""Host-side switches between execution strategies that give the same results."""
