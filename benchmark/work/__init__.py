"""Operation and byte counts of the work the inputs need, from shapes
(not from what a kernel executes), and the card's peaks they are held
against."""
