"""The yardstick's arithmetic: the card's published peaks and the
operations and bytes each kernel call and each model step need, counted
from shapes alone, whatever implements them."""
